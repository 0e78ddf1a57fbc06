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
   raises;
4. the CLI installs the SIGQUIT stack dump first thing, as the JAX
   package's does: after ``main(["serve", "--help"])`` both CLIs leave it
   registered, a ``serve --cpu`` process given SIGQUIT writes every
   thread's stack to stderr and keeps serving, and a run that moved the
   dump into its ``stack_dumps_p0.log`` puts the CLI's back when it
   ends."""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import subprocess
import sys
import time

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


@pytest.fixture
def _sigquit_restored():
    """Leave SIGQUIT as the test found it (no dump registered)."""
    faulthandler.unregister(signal.SIGQUIT)
    yield
    faulthandler.unregister(signal.SIGQUIT)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_the_cli_leaves_the_sigquit_dump_registered(side, _sigquit_restored):
    if side == "port":
        main = cli.main
    else:
        from ont_tcrconsensus_tpu.pipeline.cli import main
    with pytest.raises(SystemExit) as info:
        main(["serve", "--help"])
    assert info.value.code == 0
    assert faulthandler.unregister(signal.SIGQUIT) is True


def test_a_serve_process_survives_sigquit_and_dumps_its_threads(tmp_path):
    template = tmp_path / "template.json"
    template.write_text(json.dumps({"reference_file": str(tmp_path / "r.fa"),
                                    "fastq_pass_dir": str(tmp_path / "fq")}))
    state = tmp_path / "state"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    err_path = tmp_path / "stderr.log"
    with open(err_path, "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ont_tcrconsensus_tpu_torch", "serve", str(template),
             "--cpu", "--port", "0", "--state-dir", str(state), "--no-prewarm"],
            env=env, cwd=tmp_path, stdout=subprocess.DEVNULL, stderr=err)
    try:
        deadline = time.monotonic() + 120
        while not (state / "serve_info.json").exists():
            assert proc.poll() is None, err_path.read_text()[-2000:]
            assert time.monotonic() < deadline, "the daemon never wrote serve_info.json"
            time.sleep(0.1)
        proc.send_signal(signal.SIGQUIT)
        deadline = time.monotonic() + 30
        while "Thread 0x" not in err_path.read_text(errors="replace"):
            assert time.monotonic() < deadline, err_path.read_text()[-2000:]
            time.sleep(0.1)
        time.sleep(0.5)
        assert proc.poll() is None  # still serving
        port = json.loads((state / "serve_info.json").read_text())["port"]
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/jobs", timeout=30) as resp:
            assert resp.status == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) in (0, 143)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    dump = err_path.read_text(errors="replace")
    assert "Current thread" in dump or "Thread 0x" in dump


# a process that registers the CLI's dump, runs a lane, then sends itself
# SIGQUIT: the dump must reach stderr, not the run's closed log
_RUN_THEN_SIGQUIT = r"""
import json, os, signal, sys, time
from ont_tcrconsensus_tpu_torch.pipeline import cli, run
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig
cli._install_stack_dump_signal()
with open(sys.argv[1]) as fh:
    got = run.run_with_config(RunConfig.from_dict(json.load(fh)), device="cpu")
log = sys.argv[2]
before = os.path.getsize(log)
sys.stderr.write("SIGQUIT SENT\n")
sys.stderr.flush()
os.kill(os.getpid(), signal.SIGQUIT)
time.sleep(0.5)
print(json.dumps({"libraries": sorted(got), "log_before": before,
                  "log_after": os.path.getsize(log)}))
"""


def test_a_run_puts_the_cli_s_dump_back_when_it_ends(tmp_path):
    cfg = _empty_library_fixture(tmp_path / "lane")
    log = tmp_path / "lane" / "fastq_pass" / "nano_tcr" / "stack_dumps_p0.log"
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "TCR_CHAOS")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _RUN_THEN_SIGQUIT, str(cfg), str(log)],
                          capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]  # the dump did not kill it
    got = json.loads(proc.stdout.splitlines()[-1])
    assert "barcode02" in got["libraries"]
    # the run's file dump is gone: nothing new in its log ...
    assert got["log_after"] == got["log_before"]
    # ... and the CLI's stderr dump is back
    after = proc.stderr.split("SIGQUIT SENT\n", 1)[1]
    assert "most recent call first" in after
