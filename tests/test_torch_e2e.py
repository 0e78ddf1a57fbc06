"""The PyTorch port end to end against the JAX package: the counts CSV and
the merged consensus FASTA must be byte-identical, and the counts equal the
simulator's truth. Two lanes: the JAX package's e2e lane (seed 11, four
pre-trimmed regions of 700-850 nt, iid errors) and an untrimmed one (seed
23, adapters and primers, the systematic ONT error model, a near-duplicate
pair and a negative control). Each lane runs under ``rnn`` polish (the
default: no ``polish_method`` key, so the bi-GRU polisher with the bundled
weights) and under ``poa``, at read batch 64. A third lane (seed 29, 2-4
reads a molecule, clusters of 2 subreads kept) runs ``rnn`` only: there the
polisher, its depth-2 pass on qualities and strands included, changes the
consensus, so its counts are the JAX package's, not the truth. The port
runs through its CLI with ``--cpu``; without that flag it asks for the CUDA
card. On every lane the port writes every file the JAX package writes under
``nano_tcr/`` (the QC logs and CSVs, both error profiles, the
self-homology logs, ``robustness_report.json``, ...), byte for byte, but
for the files :data:`NOT_BYTE_COMPARED` names, and nothing else."""

import json

import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu.io import fastx as jfastx  # noqa: E402
from ont_tcrconsensus_tpu.io import simulator as jsim  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.run import run_with_config as jax_run  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import cli  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import run as trun  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig  # noqa: E402

ARTIFACTS = ("counts/umi_consensus_counts.csv", "fasta/merged_consensus.fasta")
# files under nano_tcr/ of the JAX run that are not compared byte for byte
NOT_BYTE_COMPARED = {
    "telemetry.json": "the obs slice: timings, compared by schema once ported",
    "history.jsonl": "the obs slice: a run ledger keyed by timings and commit",
    "logs/trace.json": "the obs slice: a timeline (written only under telemetry full)",
    "barcode01/stage_manifest.json": "completion timestamps",
    "barcode01/logs/stage_timing.tsv": "seconds: its stage column is compared instead",
}
TIMING = "barcode01/logs/stage_timing.tsv"


def _tree(root) -> dict[str, bytes]:
    nano = root / "fastq_pass" / "nano_tcr"
    return {p.relative_to(nano).as_posix(): p.read_bytes()
            for p in sorted(nano.rglob("*")) if p.is_file()}


def _lane_dir(root, lib, method, lane):
    root.mkdir()
    jfastx.write_fasta(root / "reference.fa", lib.reference.items())
    (root / "fastq_pass" / "barcode01").mkdir(parents=True)
    jfastx.write_fastq(root / "fastq_pass" / "barcode01" / "barcode01.fastq.gz", lib.reads)
    return {
        "reference_file": str(root / "reference.fa"),
        "fastq_pass_dir": str(root / "fastq_pass"),
        "minimal_length": 600,
        "min_reads_per_cluster": 2 if lane == "lowdepth" else 4,
        "read_batch_size": 64,
        "delete_tmp_files": False,
        **({} if method == "rnn" else {"polish_method": method}),
    }


LANES = {
    "clean": dict(seed=11, num_regions=4, molecules_per_region=(2, 3),
                  reads_per_molecule=(5, 8), sub_rate=0.006, ins_rate=0.003,
                  del_rate=0.003, region_len=(700, 850)),
    "untrimmed": dict(seed=23, num_regions=3, molecules_per_region=(2, 3),
                      reads_per_molecule=(5, 8), region_len=(700, 850),
                      with_adapters=True, num_similar_pairs=1, similar_divergence=0.01,
                      num_negative_controls=1),
    "lowdepth": dict(seed=29, num_regions=3, molecules_per_region=(2, 3),
                     reads_per_molecule=(2, 5), region_len=(700, 850), with_adapters=True,
                     num_similar_pairs=1, similar_divergence=0.01, num_negative_controls=1),
}
RUNS = [("clean", "poa"), ("clean", "rnn"), ("untrimmed", "poa"), ("untrimmed", "rnn"),
        ("lowdepth", "rnn")]


@pytest.fixture(scope="module", params=RUNS, ids="-".join)
def runs(request, tmp_path_factory):
    lane, method = request.param
    tmp = tmp_path_factory.mktemp(f"torch_e2e_{lane}_{method}")
    kw = dict(LANES[lane])
    if kw.get("with_adapters"):
        kw["error_model"] = jsim.OntErrorModel()
    lib = jsim.simulate_library(**kw)
    port_cfg = _lane_dir(tmp / "port", lib, method, lane)
    cfg_path = tmp / "port_config.json"
    cfg_path.write_text(json.dumps(port_cfg))
    assert cli.main([str(cfg_path), "--cpu"]) == 0
    jax_results = jax_run(JConfig.from_dict(_lane_dir(tmp / "jax", lib, method, lane)))
    sides = ["port", "jax"]
    if lane == "lowdepth":  # the vote consensus alone, for what the polisher changed
        trun.run_with_config(RunConfig.from_dict(_lane_dir(tmp / "vote", lib, "poa", lane)),
                             device="cpu")
        sides.append("vote")
    trees = {side: _tree(tmp / side) for side in sides}
    out = {side: {rel: trees[side][f"barcode01/{rel}"] for rel in ARTIFACTS} for side in sides}
    return lib, out, jax_results, lane, trees


def _config(tmp_path, **knobs):
    """A run config whose checks fail before any file is read."""
    return RunConfig.from_dict({
        "reference_file": str(tmp_path / "reference.fa"),
        "fastq_pass_dir": str(tmp_path), "polish_method": "poa", **knobs,
    })


@pytest.mark.parametrize("rel", ARTIFACTS)
def test_artifacts_byte_identical_to_jax(runs, rel):
    _, out, _, _, _ = runs
    assert out["port"][rel] == out["jax"][rel]


def test_every_jax_artifact_is_written_byte_identical(runs):
    *_, trees = runs
    port, jax = trees["port"], trees["jax"]
    compared = sorted(set(jax) - set(NOT_BYTE_COMPARED))
    assert "robustness_report.json" in compared
    assert "barcode01/logs/merged_consensus_align_error_profile.log" in compared
    assert [rel for rel in compared if rel not in port] == []
    assert [rel for rel in compared if port[rel] != jax[rel]] == []


def test_the_port_writes_nothing_the_jax_run_does_not(runs):
    *_, trees = runs
    assert sorted(set(trees["port"]) - set(trees["jax"])) == []


def test_stage_timing_carries_the_jax_stage_names(runs):
    *_, trees = runs

    def table(side):
        rows = trees[side][TIMING].decode().splitlines()
        assert rows[0] == "stage\tseconds\tcalls"
        seconds = [float(r.split("\t")[1]) for r in rows[1:]]
        assert seconds == sorted(seconds, reverse=True)  # largest first, as in JAX
        return sorted(r.split("\t")[0] for r in rows[1:])

    assert table("port") == table("jax")
    assert "round1_error_profile_bg" in table("port")


def test_counts_equal_the_truth(runs):
    lib, out, jax_results, lane, _ = runs
    rows = out["port"]["counts/umi_consensus_counts.csv"].decode().splitlines()
    assert rows[0] == "TCR,Count"
    got = {k: int(v) for k, v in (r.rsplit(",", 1) for r in rows[1:])}
    assert got == jax_results["barcode01"]
    if lane != "lowdepth":
        assert got == lib.true_counts
        fasta = out["port"]["fasta/merged_consensus.fasta"].decode()
        assert fasta.count(">") == sum(lib.true_counts.values())
    else:  # the polisher changed the consensus, and the counts moved towards the truth
        vote_rows = out["vote"]["counts/umi_consensus_counts.csv"].decode().splitlines()[1:]
        vote = {k: int(v) for k, v in (r.rsplit(",", 1) for r in vote_rows)}
        assert out["port"]["fasta/merged_consensus.fasta"] != out["vote"][
            "fasta/merged_consensus.fasta"]

        def missed(counts):
            return sum(abs(counts.get(k, 0) - lib.true_counts.get(k, 0))
                       for k in set(counts) | set(lib.true_counts))

        assert missed(got) < missed(vote)


def test_the_card_is_the_default_and_its_absence_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.run_with_config(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.run_with_config(cfg, device="cuda")
    assert not (tmp_path / "nano_tcr").exists()  # nothing ran


@pytest.mark.parametrize("knob,value", [
    ("mesh_shape", {"data": 2}), ("distributed", True),
    ("resume", True), ("chaos", [{"site": "assign.dispatch", "kind": "transient"}]),
])
def test_knobs_of_later_slices_raise(tmp_path, knob, value):
    cfg = _config(tmp_path, **{knob: value})
    with pytest.raises(NotImplementedError):
        trun.run_with_config(cfg, device="cpu")
