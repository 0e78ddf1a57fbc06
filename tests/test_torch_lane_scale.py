"""The port's lane-scale proof (``scripts/torch_lane_scale_proof.py``)
against the JAX package's ``scripts/lane_scale_proof.py``: the same
dataset from the same arguments (reference FASTA bytes, decompressed FASTQ
records, true counts); the artifact's keys and its refusal of the root
``LANE_SCALE*.md`` files; and, slow, a tiny ``--force-cpu`` run whose
counts equal the JAX package's run and the medium tier of
``tests/test_lane_scale.py`` through the port."""

import gzip
import importlib.util
import json
import os

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_lane_scale_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root) -> tuple[bytes, bytes]:
    with open(os.path.join(root, "reference.fa"), "rb") as fh:
        ref = fh.read()
    with gzip.open(os.path.join(root, "fastq_pass", "barcode01", "barcode01.fastq.gz")) as fh:
        return ref, fh.read()


@pytest.mark.parametrize("reads,min_heavy", ((300, 40), (120, 30)))
def test_dataset_equals_the_jax_scripts(tmp_path, reads, min_heavy):
    twin, jax_script = _script("torch_lane_scale_proof"), _script("lane_scale_proof")
    lib, heavy, n_heavy = twin.build_dataset(str(tmp_path / "port"), reads, min_heavy=min_heavy)
    jlib, jheavy, jn_heavy = jax_script.build_dataset(str(tmp_path / "jax"), reads,
                                                      min_heavy=min_heavy)
    assert (heavy, n_heavy) == (jheavy, jn_heavy)
    assert lib.true_counts == jlib.true_counts
    assert lib.reads == jlib.reads
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


JAX_KEYS = {"n_reads", "heavy_region_molecules", "round2_assign", "backend", "wall_seconds",
            "reads_per_sec", "counts_exact", "count_diffs", "heavy_region_count",
            "precision_at_depth", "stage_timing_sec", "peak_device_mem_gb",
            "peak_host_rss_gb"}


def test_artifact_keys_and_exit_code(tmp_path, monkeypatch):
    """The artifact has the JAX script's keys; the exit code follows the
    counts; the root LANE_SCALE*.md files are refused. The pipeline is
    replaced by one returning the truth (or one molecule short)."""
    twin = _script("torch_lane_scale_proof")
    from ont_tcrconsensus_tpu_torch.pipeline import run as run_mod

    truth = {}

    def fake_run(cfg, device=None):
        return {"barcode01": dict(truth)}

    monkeypatch.setattr(run_mod, "run_with_config", fake_run)
    real_build = twin.build_dataset

    def build(root, target_reads, min_heavy):
        lib, heavy, n = real_build(root, target_reads, min_heavy=min_heavy)
        truth.update(lib.true_counts)
        return lib, heavy, n

    monkeypatch.setattr(twin, "build_dataset", build)
    out = tmp_path / "a.json"
    args = ["--reads", "60", "--min-heavy", "10", "--force-cpu", "--root",
            str(tmp_path / "data"), "--out", str(out)]
    assert twin.main(args) == 0
    art = json.loads(out.read_text())
    assert JAX_KEYS <= set(art)
    assert art["backend"] == "cpu" and art["counts_exact"] is True
    assert art["peak_device_mem_gb"] is None and art["n_reads"] == 60
    assert art["kernel_launches"] == {"B1": 0, "B2": 0, "B3": 0, "B4": 0, "B5": 0, "B6": 0}
    heavy = "TCR0000"
    real_build_truth = dict(truth)

    def short(cfg, device=None):
        return {"barcode01": {**real_build_truth, heavy: real_build_truth[heavy] - 1}}

    monkeypatch.setattr(run_mod, "run_with_config", short)
    assert twin.main(args) == 1
    art = json.loads(out.read_text())
    n = real_build_truth[heavy]
    assert art["counts_exact"] is False and art["count_diffs"] == {heavy: [n - 1, n]}
    assert art["heavy_region_count"] == [n - 1, n] and art["heavy_region_molecules"] == n
    with pytest.raises(SystemExit, match="LANE_SCALE"):
        twin.main(args[:-1] + [os.path.join(REPO, "LANE_SCALE.md")])
    assert twin.WORK.startswith(os.path.join(REPO, "build"))


def _jax_counts(tmp_path, reads: int, min_heavy: int):
    jax_script = _script("lane_scale_proof")
    lib, heavy, _ = jax_script.build_dataset(str(tmp_path), reads, min_heavy=min_heavy)
    from ont_tcrconsensus_tpu.pipeline.config import RunConfig
    from ont_tcrconsensus_tpu.pipeline.run import run_with_config

    cfg = RunConfig.from_dict({
        "reference_file": str(tmp_path / "reference.fa"),
        "fastq_pass_dir": str(tmp_path / "fastq_pass"),
        "minimal_length": 1000, "min_reads_per_cluster": 2, "delete_tmp_files": False,
        "write_intermediate_fastas": False, "error_profile_sample": 0,
    })
    return run_with_config(cfg)["barcode01"], lib.true_counts, heavy


@pytest.mark.slow
def test_tiny_cpu_artifact_counts_equal_the_jax_run(tmp_path):
    """~50 s for each package's run on the CPU (24 regions' self-homology
    alone is ~30 s), so the pair is slow-marked."""
    twin = _script("torch_lane_scale_proof")
    out = tmp_path / "a.json"
    rc = twin.main(["--reads", "30", "--min-heavy", "6", "--force-cpu", "--root",
                    str(tmp_path / "port"), "--out", str(out)])
    art = json.loads(out.read_text())
    assert JAX_KEYS <= set(art) and art["backend"] == "cpu"
    got, want, heavy = _jax_counts(tmp_path / "jax", 30, 6)
    diffs = {k: [got.get(k, 0), want.get(k, 0)] for k in set(got) | set(want)
             if got.get(k, 0) != want.get(k, 0)}
    assert art["count_diffs"] == diffs
    assert art["counts_exact"] == (got == want) and rc == (0 if got == want else 1)
    assert art["heavy_region_count"] == [got.get(heavy, 0), want[heavy]]


@pytest.mark.slow
def test_lane_scale_medium_counts_through_the_port(tmp_path):
    """The medium tier of ``tests/test_lane_scale.py`` through the port on
    the CPU: ~3k reads, >= 600 unique UMIs in the heavy region (the
    shortlist regime), the heavy region >= 0.96 of the truth and never
    over it, every other region exact."""
    twin = _script("torch_lane_scale_proof")
    out = tmp_path / "a.json"
    twin.main(["--reads", "3000", "--min-heavy", "600", "--force-cpu", "--root",
               str(tmp_path / "data"), "--out", str(out)])
    art = json.loads(out.read_text())
    heavy_got, heavy_want = art["heavy_region_count"]
    assert art["heavy_region_molecules"] >= 600 and art["n_reads"] >= 2_500
    assert heavy_got >= 0.96 * heavy_want, (heavy_got, heavy_want)
    assert heavy_got <= heavy_want, "overcount: molecules invented"
    rest = {k: v for k, v in art["count_diffs"].items() if k != "TCR0000"}
    assert not rest, rest
