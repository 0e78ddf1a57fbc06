"""Three faults found in the port against the JAX package, each with its
fixture:

1. a failed library must not abort the run: two libraries of one simulated
   lane (seed 11) with ``barcode01.fastq.gz`` cut in half; both packages
   count ``barcode02``, write ``failed_libraries_p0.log`` and raise
   ``RuntimeError: 1 library(ies) failed: ['barcode01']``;
2. the split log prints a set, so its order follows the process's string
   hash: each package runs in its own process on the JAX package's
   empty-library fixture (one empty library, one of eight 40-nt reads, two
   regions) with one ``PYTHONHASHSEED`` and one ``TCR_CHAOS`` plan, and
   every file under ``nano_tcr/`` but the files of timings is equal;
3. ``TCR_CONSENSUS_FORCE_CPU`` puts the port's CLI on the CPU, as it does
   the JAX package's; without it (and without ``--cpu``) a host with no card
   raises."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu.io import fastx as jfastx  # noqa: E402
from ont_tcrconsensus_tpu.io import simulator as jsim  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.run import run_with_config as jax_run  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import cli  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import run as trun  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig  # noqa: E402
from test_torch_e2e import _one_torch_thread  # noqa: E402,F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# files of timings under nano_tcr/, never byte-compared
TIMED = ("telemetry.json", "history.jsonl", "stage_manifest.json", "stage_timing.tsv")


def _config(root, **knobs) -> dict:
    return {"reference_file": str(root / "reference.fa"),
            "fastq_pass_dir": str(root / "fastq_pass"), "minimal_length": 600,
            "min_reads_per_cluster": 4, "read_batch_size": 64, "polish_method": "poa",
            "delete_tmp_files": False, **knobs}


def test_a_failed_library_is_skipped_and_reported_as_in_jax(tmp_path):
    lib = jsim.simulate_library(seed=11, num_regions=4, molecules_per_region=(2, 3),
                                reads_per_molecule=(5, 8), sub_rate=0.006, ins_rate=0.003,
                                del_rate=0.003, region_len=(700, 850))
    msgs, counts = {}, {}
    for side, (config_cls, run) in {
        "port": (RunConfig, lambda cfg: trun.run_with_config(cfg, device="cpu")),
        "jax": (JConfig, jax_run),
    }.items():
        root = tmp_path / side
        root.mkdir()
        jfastx.write_fasta(root / "reference.fa", lib.reference.items())
        for bc in ("barcode01", "barcode02"):
            (root / "fastq_pass" / bc).mkdir(parents=True)
            jfastx.write_fastq(root / "fastq_pass" / bc / f"{bc}.fastq.gz", lib.reads)
        cut = root / "fastq_pass" / "barcode01" / "barcode01.fastq.gz"
        raw = cut.read_bytes()
        cut.write_bytes(raw[: len(raw) // 2])
        with pytest.raises(RuntimeError) as info:
            run(config_cls.from_dict(_config(root)))
        msgs[side] = str(info.value)
        nano = root / "fastq_pass" / "nano_tcr"
        counts[side] = (nano / "barcode02" / "counts" / "umi_consensus_counts.csv").read_bytes()
        log = (nano / "failed_libraries_p0.log").read_text().splitlines()
        assert [ln.split("\t")[0] for ln in log] == ["barcode01"]
        assert not (nano / "barcode01" / "counts" / "umi_consensus_counts.csv").exists()
    assert msgs["port"] == msgs["jax"]
    assert msgs["port"].startswith("1 library(ies) failed: ['barcode01']")
    assert counts["port"] == counts["jax"]
    got = dict(row.rsplit(",", 1) for row in counts["port"].decode().splitlines()[1:])
    assert {k: int(v) for k, v in got.items()} == lib.true_counts


def _empty_library_fixture(root):
    root.mkdir()
    jfastx.write_fasta(root / "reference.fa",
                       [("regionA", "ACGT" * 200), ("regionB", "GGCATT" * 150)])
    for bc in ("barcode01", "barcode02"):
        (root / "fastq_pass" / bc).mkdir(parents=True)
    (root / "fastq_pass" / "barcode01" / "barcode01.fastq").write_bytes(b"")
    jfastx.write_fastq(root / "fastq_pass" / "barcode02" / "barcode02.fastq.gz",
                       [(f"r{i}", "ACGT" * 10, "I" * 40) for i in range(8)])
    cfg = root / "config.json"
    cfg.write_text(json.dumps(_config(root, contracts="strict")))
    return cfg


def _tree(root) -> dict[str, bytes]:
    nano = root / "fastq_pass" / "nano_tcr"
    return {p.relative_to(nano).as_posix(): p.read_bytes()
            for p in sorted(nano.rglob("*")) if p.is_file() and p.name not in TIMED}


def test_each_package_in_its_own_process_writes_the_same_files(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, PYTHONHASHSEED="0", JAX_PLATFORMS="cpu",
               TCR_CHAOS='[{"site": "resume.verify", "kind": "corrupt-artifact"}]')
    trees = {}
    for side, pkg in (("port", "ont_tcrconsensus_tpu_torch"), ("jax", "ont_tcrconsensus_tpu")):
        cfg = _empty_library_fixture(tmp_path / side)
        proc = subprocess.run(
            [sys.executable, "-c",
             f"import sys; from {pkg}.pipeline.cli import main; sys.exit(main(sys.argv[1:]))",
             str(cfg), "--cpu"],
            env=env, cwd=tmp_path, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        trees[side] = _tree(tmp_path / side)
    port, jax = trees["port"], trees["jax"]
    assert sorted(port) == sorted(jax)
    assert [rel for rel in sorted(jax) if port[rel] != jax[rel]] == []
    split = "barcode02/logs/barcode02_filter_and_split_reads_by_region_cluster.err"
    assert b"regionA" in port[split] and b"regionB" in port[split]
    assert json.loads(port["robustness_report.json"])["chaos"]["specs"][0]["site"] == \
        "resume.verify"


def test_force_cpu_puts_the_cli_on_the_cpu_and_only_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("TCR_CONSENSUS_FORCE_CPU", raising=False)
    cfg = _empty_library_fixture(tmp_path / "card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(cfg)])
    assert not (tmp_path / "card" / "fastq_pass" / "nano_tcr").exists()
    monkeypatch.setenv("TCR_CONSENSUS_FORCE_CPU", "1")
    cfg = _empty_library_fixture(tmp_path / "forced")
    assert cli.main([str(cfg)]) == 0
    nano = tmp_path / "forced" / "fastq_pass" / "nano_tcr"
    assert (nano / "barcode02" / "counts" / "umi_consensus_counts.csv").read_text() == \
        "TCR,Count\n"
    assert json.loads((nano / "history.jsonl").read_text().splitlines()[0])["backend"] == "cpu"
