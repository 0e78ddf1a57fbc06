"""The control and the faults come out as not correct: the whole run on
the CPU at a tiny size, with the control in the program's place (its EE
filter and sketch cosine in bfloat16 and, under ``rnn``, its own
bfloat16 polisher), or the program broken underneath (the harness's look
for a card skipped)."""

import os

import numpy as np
import pytest

from tcrbench import run
from tcrbench.tests._tiny import TINY

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# four extras a molecule, their EE rates spread across the limit; on seed
# 14 two reads' rates lie close enough to it for bfloat16 to move them over
NEAR_LIMIT = {**TINY, "extra_reads": {"per_molecule": [4, 4], "truncated_share": 0.25,
                                      "truncated_len": [500, 1400], "quality_shift": [5.0, 5.8]}}


def _run(cell, tmp_path, control=False, seed=7, traffic=TINY):
    return run.run_cell(cell, seed, 0.1, False, root=ROOT, device="cpu", traffic=traffic,
                        control=control, work=str(tmp_path / "work"))


def _failing(result):
    return sorted(k for k, c in result["check"].items() if c["value"] > c["limit"])


def test_rnn_control_the_programs_bfloat16_polisher(tmp_path):
    r = _run("rnn.deep_lane", tmp_path, control=True)
    assert r["correct"] is False and "polisher_conf_gap" in _failing(r)


def test_poa_control_the_programs_bfloat16_filter(tmp_path):
    sound = _run("poa.clonal_lane", tmp_path, seed=14, traffic=NEAR_LIMIT)
    assert sound["correct"] is True, sound["check"]
    r = _run("poa.clonal_lane", tmp_path, control=True, seed=14, traffic=NEAR_LIMIT)
    assert r["correct"] is False and "assign_off" in _failing(r)


def _unchanged_vote(orig):
    def vote(base_at, ins_cnt, ins_base, drafts, draft_lens):
        out, lens = orig(base_at, ins_cnt, ins_base, drafts, draft_lens)
        Ld = base_at.shape[2]
        keep = drafts[:, :Ld].to(out.dtype)
        return out.new_full(out.shape, 5).index_copy_(1, __import__("torch").arange(Ld),
                                                      keep), draft_lens.to(lens.dtype)
    return vote


def _half_records(orig):
    def records(store, parts, max_pattern_dist):
        return orig(store, parts, max_pattern_dist)[::2]
    return records


def _counts_altered(orig):
    def write(region_counts, counts_dir, *a, **kw):
        first = sorted(region_counts)[0]
        return orig({**region_counts, first: region_counts[first] + 1}, counts_dir, *a, **kw)
    return write


@pytest.mark.parametrize("fault,module,name,expect", [
    ("state unchanged: the vote returns its draft", "ont_tcrconsensus_tpu_torch.ops.consensus",
     "vote_columns_batch", "consensus_off"),
    ("half of the batch left out: every other UMI record", "ont_tcrconsensus_tpu_torch.pipeline.stages",
     "build_umi_records", "counts_off"),
    ("an answer altered where produced: a count", "ont_tcrconsensus_tpu_torch.pipeline.stages",
     "write_counts_csv", "counts_off"),
])
def test_faults_fail(fault, module, name, expect, tmp_path, monkeypatch):
    import importlib

    mod = importlib.import_module(module)
    wrap = {"vote_columns_batch": _unchanged_vote, "build_umi_records": _half_records,
            "write_counts_csv": _counts_altered}[name]
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    r = _run("poa.clonal_lane", tmp_path)
    assert r["correct"] is False and expect in _failing(r), (fault, r["check"])
    assert np.isfinite(r["metrics"]["reads_per_s"]["value"])
