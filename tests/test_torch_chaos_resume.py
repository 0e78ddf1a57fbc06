"""Chaos drills, crash and resume: a torn manifest, a preemption at the
round-1 checkpoint (the CLI exits 143), a process kill there (exit 137, in
a subprocess), a corrupted artifact under each ``verify_resume`` mode, a
stalled polish dispatch under ``stage_timeout_s``, and a truncated library
beside a good one. Each drill runs the port and the JAX package on the
JAX package's chaos lane under one chaos plan; both must end with the same
artifacts (those of an undisturbed run, where the drill recovers), the same
counts and the same robustness events (site, classification, outcome)."""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from test_torch_chaos import (  # noqa: E402,F401  (fixtures used by name)
    COUNTS_CSV,
    MANIFEST,
    REPORT,
    SIDES,
    artifacts,
    cfg_dict,
    disarm,
    events,
    _one_torch_thread,  # noqa: F401  (autouse: one intra-op thread)
    lane,  # noqa: F401  (the module-scoped lane fixture)
    manifest_stages,
    report,
    run,
    stage,
)

pytestmark = pytest.mark.chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": "ont_tcrconsensus_tpu_torch", "jax": "ont_tcrconsensus_tpu"}


@pytest.fixture(autouse=True)
def _disarm():
    yield
    disarm()


def _completed(lane, tmp_path, side):
    """A finished run of ``side`` (a copy of the lane's baseline)."""
    root = tmp_path / side
    shutil.copytree(lane["tmp"] / f"baseline_{side}", root)
    return root


def test_torn_manifest_resume_regenerates_as_in_jax(lane, tmp_path):
    """The counts mark tears mid-write (skip=1: the round-1 mark is the
    first write): the torn manifest reads as no stages done, and resume
    reruns the library to the same bytes."""
    plan = [{"site": "layout.manifest_write", "kind": "torn", "skip": 1}]
    for side in SIDES:
        root = stage(lane["inputs"], tmp_path / side)
        assert run(side, root, chaos=plan)["barcode01"] == lane["lib"].true_counts
        assert SIDES[side][3].fired("layout.manifest_write") == 1
        with pytest.raises(ValueError):
            json.loads((root / "fastq_pass" / MANIFEST).read_text())
        disarm()
        assert run(side, root, resume=True)["barcode01"] == lane["lib"].true_counts
        assert artifacts(root) == lane["artifacts"]
        assert "counts" in manifest_stages(root)


def test_preemption_exits_143_and_resume_completes_as_in_jax(lane, tmp_path):
    got = {}
    for side in SIDES:
        root = stage(lane["inputs"], tmp_path / side)
        cfg_path = tmp_path / f"{side}.json"
        cfg_path.write_text(json.dumps(cfg_dict(root, chaos=[
            {"site": "run.round1_checkpoint", "kind": "preempt"}])))
        main = SIDES[side][2]
        assert main([str(cfg_path), "--cpu"]) == 143
        done = manifest_stages(root)
        assert "round1_consensus" in done and "counts" not in done
        assert (root / "fastq_pass" / REPORT).exists()
        # round-1 QC committed before the checkpoint
        assert (root / "fastq_pass" / "nano_tcr" / "barcode01" / "logs"
                / "barcode01_align_error_profile.log").exists()
        assert not (root / "fastq_pass" / COUNTS_CSV).exists()
        disarm()
        assert run(side, root, resume=True)["barcode01"] == lane["lib"].true_counts
        assert artifacts(root) == lane["artifacts"]
        got[side] = events(root)
    assert got["port"] == got["jax"]


@pytest.mark.slow
def test_process_kill_midstage_resume_byte_identical_as_in_jax(lane, tmp_path):
    for side, pkg in PACKAGES.items():
        root = stage(lane["inputs"], tmp_path / side)
        cfg_path = tmp_path / f"{side}.json"
        cfg_path.write_text(json.dumps(cfg_dict(root, chaos=[
            {"site": "run.round1_checkpoint", "kind": "kill"}])))
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
        env.pop("TCR_CHAOS", None)
        proc = subprocess.run(
            [sys.executable, "-c",
             f"import sys; from {pkg}.pipeline.cli import main; sys.exit(main(sys.argv[1:]))",
             str(cfg_path), "--cpu"],
            env=env, capture_output=True, text=True, timeout=900,
        )
        assert proc.returncode == 137, proc.stderr[-2000:]
        assert "CHAOS: killing process" in proc.stderr
        done = manifest_stages(root)
        assert "round1_consensus" in done and "counts" not in done
        assert run(side, root, resume=True)["barcode01"] == lane["lib"].true_counts
        assert artifacts(root) == lane["artifacts"]


def test_corrupt_artifact_full_verify_recomputes_as_in_jax(lane, tmp_path):
    evs = {}
    for side in SIDES:
        root = _completed(lane, tmp_path, side)
        got = run(side, root, resume=True, verify_resume="full", chaos=[
            {"site": "resume.verify", "kind": "corrupt-artifact"}])
        assert SIDES[side][3].fired("resume.verify") == 1
        assert got["barcode01"] == lane["lib"].true_counts
        assert artifacts(root) == lane["artifacts"]  # recomputed over the rot
        (ev,) = [e for e in report(root)["events"] if e["site"] == "resume.verify"]
        assert ev["detail"] == {"library": "barcode01", "stage": "counts", "mode": "full"}
        assert "sha256" in ev["error"]
        assert manifest_stages(root)["counts"]["artifacts"]
        evs[side] = events(root)
        disarm()
    assert evs["port"] == evs["jax"]
    assert evs["port"][("resume.verify", "integrity", "rerun")] == 1


@pytest.mark.parametrize("mode", ["off", "fast"])
def test_corrupt_artifact_blind_trust_as_in_jax(lane, tmp_path, mode):
    rotted = {}
    for side in SIDES:
        root = _completed(lane, tmp_path, side)
        run(side, root, resume=True, verify_resume=mode, chaos=[
            {"site": "resume.verify", "kind": "corrupt-artifact"}])
        got = (root / "fastq_pass" / COUNTS_CSV).read_bytes()
        want = lane["artifacts"][COUNTS_CSV]
        assert len(got) == len(want) and got != want  # size-preserving rot, unseen
        assert all(e["site"] != "resume.verify" for e in report(root)["events"])
        rotted[side] = got
        disarm()
    assert rotted["port"] == rotted["jax"]


GENEROUS_S = 60.0
STALL_HARD_S = 10.0


def _short_polish_deadline(watchdog_cls):
    """The configured watchdog with a short deadline for ``round1_polish``
    only, so the stall is cancelled in seconds while every other stage of a
    loaded CPU keeps the generous base."""

    class ShortPolish(watchdog_cls):
        @contextlib.contextmanager
        def guard(self, name, units=0):
            with super().guard(name, units) as entry:
                if name == "round1_polish":
                    entry.hard_s = STALL_HARD_S
                    entry.soft_s = STALL_HARD_S * self.soft_fraction
                yield entry

    return ShortPolish


def test_stall_is_detected_cancelled_and_retried_as_in_jax(lane, tmp_path, monkeypatch):
    """A stall at the polish dispatch (progress stops, nothing raises) is
    reported at the soft deadline with a stack dump, cancelled at the hard
    one into the transient retry, and the run completes unchanged."""
    from ont_tcrconsensus_tpu.pipeline import run as jrun
    from ont_tcrconsensus_tpu_torch.pipeline import run as trun

    for mod in (trun, jrun):
        monkeypatch.setattr(mod.watchdog, "Watchdog",
                            _short_polish_deadline(mod.watchdog.Watchdog))
    knobs = dict(stage_timeout_s=GENEROUS_S, cluster_batch_size=2,
                 chaos=[{"site": "polish.dispatch", "kind": "stall"}])
    evs = {}
    for side in SIDES:
        root = stage(lane["inputs"], tmp_path / side)
        assert run(side, root, **knobs)["barcode01"] == lane["lib"].true_counts
        assert artifacts(root) == lane["artifacts"]
        rep = report(root)
        cancels = [e for e in rep["events"]
                   if e["site"] == "watchdog.stall" and e["outcome"] == "hard_cancel"]
        assert [e["detail"]["stage"] for e in cancels] == ["round1_polish"]
        assert cancels[0]["detail"]["stalled_s"] <= STALL_HARD_S + 1.0
        assert any(e["site"] == "polish.dispatch" and e["outcome"] == "retried"
                   and "DEADLINE_EXCEEDED" in e.get("error", "") for e in rep["events"])
        wlog = (root / "fastq_pass" / "nano_tcr" / "barcode01" / "logs"
                / "watchdog.log").read_text()
        assert "dumping all thread stacks" in wlog and "exceeded its hard deadline" in wlog
        # a soft detection is a timing observation (a slow host may add
        # one on a slow legitimate chunk): every other event is compared
        # by count, soft detections by presence
        soft = ("watchdog.stall", "stall", "stall_detected")
        got = events(root)
        assert got[soft] >= 1
        evs[side] = {k: (v if k != soft else 1) for k, v in got.items()}
        disarm()
    assert evs["port"] == evs["jax"]


def test_truncated_library_fails_beside_a_good_one_as_in_jax(lane, tmp_path):
    """``truncate-file`` cuts the first library's input mid gzip stream:
    that library fails (the default ``on_bad_record: fail``), the second is
    counted, ``failed_libraries_p0.log`` names the first, and the run
    raises."""
    plan = [{"site": "ingest.library_fastq", "kind": "truncate-file"}]
    msgs = {}
    for side in SIDES:
        root = stage(lane["inputs"], tmp_path / side)
        bc2 = root / "fastq_pass" / "barcode02"
        bc2.mkdir()
        shutil.copy(root / "fastq_pass" / "barcode01" / "barcode01.fastq.gz",
                    bc2 / "barcode02.fastq.gz")
        with pytest.raises(RuntimeError, match=r"1 library\(ies\) failed: \['barcode01'\]") as e:
            run(side, root, chaos=plan)
        msgs[side] = str(e.value)
        nano = root / "fastq_pass" / "nano_tcr"
        assert (nano / "barcode02" / "counts" / "umi_consensus_counts.csv").read_bytes() == \
            lane["artifacts"][COUNTS_CSV]
        assert (nano / "failed_libraries_p0.log").read_text().startswith("barcode01\t")
        assert not (nano / "barcode01" / "counts" / "umi_consensus_counts.csv").exists()
        disarm()
    assert msgs["port"] == msgs["jax"]
