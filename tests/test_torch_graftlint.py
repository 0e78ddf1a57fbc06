"""The static lint gate over the port: ``tools/graftlint`` run over
``ont_tcrconsensus_tpu_torch``, the port's tests (``tests/test_torch_*.py``)
and scripts (``scripts/torch_*.py``) reports no finding that the port's own
baseline (``tests/torch_graftlint_baseline.json``) does not hold, and the
baseline holds nothing stale and nothing unjustified: the twin of
``scripts/tier1.sh``'s stage 0 over the JAX package. No lock-registry or
chaos-coverage finding is baselined: those are repaired (the lock table
names every mutable container; a port test arms every fault kind)."""

import glob
import json
import os
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools.graftlint.core import main as graftlint_main  # noqa: E402

BASELINE = os.path.join("tests", "torch_graftlint_baseline.json")


def _paths() -> list[str]:
    return (["ont_tcrconsensus_tpu_torch"] + sorted(glob.glob("tests/test_torch_*.py"))
            + sorted(glob.glob("scripts/torch_*.py")))


def test_port_is_clean_modulo_its_baseline(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    rc = graftlint_main(_paths() + ["--baseline", BASELINE, "--json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0, report["findings"]
    assert report["findings"] == [] and report["stale_baseline"] == []
    assert len(report["baselined"]) == 2


def test_every_baseline_entry_is_justified_and_none_hides_a_repairable_rule():
    with open(os.path.join(REPO, BASELINE)) as fh:
        entries = json.load(fh)["findings"]
    assert entries
    for e in entries:
        assert e["path"].startswith("ont_tcrconsensus_tpu_torch/"), e["path"]
        assert len(e.get("justification", "").split()) >= 10, e["path"]
        assert e["rule"] == "recompile-hazard", e["rule"]
