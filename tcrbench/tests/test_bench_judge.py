"""The comparison's own parts on crafted inputs: a cluster mixing two
molecules, or missing one of its molecule's reads, is caught; a consensus
finds its molecule through an indel in one UMI; the reads nearest the EE
limit are sampled; the reference's pileup and vote equal the port's plain
twins."""

import json
import os

import numpy as np
import pytest
import torch

from tcrbench import gen, judge
from tcrbench import reference as ref
from tcrbench.tests._tiny import TINY

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _expected(lib):
    with open(os.path.join(ROOT, "tcrbench", "configs", "tcr_poa.json")) as fh:
        cfg = json.load(fh)
    return judge.Expected(lib, {**cfg["semantics"], **cfg["knobs"]}, cfg["primers"],
                          np.arange(2), None)


def _clusters(lib, exp, rows):
    """A recorded tile whose cluster c holds the reads ``rows[c]``, each
    cluster's consensus "C<c>", and its lane's kept reads."""
    seqs = {i: ref.revcomp(lib.reads[i][1]) if lib.read_rev[i] else lib.reads[i][1]
            for r in rows for i in r}
    W = max(len(s) for s in seqs.values())
    sub = np.full((len(rows), 2, W), ref.PAD_CODE, np.uint8)
    lens = np.zeros((len(rows), 2), np.int32)
    for c, members in enumerate(rows):
        for r, i in enumerate(members):
            sub[c, r, : len(seqs[i])] = ref.encode(seqs[i])
            lens[c, r] = len(seqs[i])
    rec = {"lane": 0, "sub": sub, "lens": lens, "C": len(rows),
           "seqs": [f"C{c}" for c in range(len(rows))]}
    lane = {"oriented": {seqs[i]: exp.names[i] for i in seqs},
            "n_of": {f"C{c}": len(r) for c, r in enumerate(rows)}, "umi": {}, "umi_reads": {}}
    for i in seqs:
        lane["umi"][exp.names[i]] = "ACGT" * 16
        lane["umi_reads"].setdefault(int(lib.read_mol[i]), []).append(exp.names[i])
    return rec, lane


def _reads(lib, mol, n):
    return [int(i) for i in np.where(lib.read_mol == mol)[0][:n]]


def test_a_cluster_mixing_two_molecules_is_caught():
    lib = gen.generate(TINY, 3)
    exp = _expected(lib)
    (a,), (b,) = _reads(lib, 0, 1), _reads(lib, 1, 1)
    rec, lane = _clusters(lib, exp, [(a, b), (b,)])  # cluster 0 mixes, cluster 1 is whole
    assert judge.judge_members([rec], {0: lane}, exp) == 1


@pytest.mark.parametrize("case,off", [("left out, its UMI within the identity", 1),
                                      ("left out, its UMI misread further", 0),
                                      ("fewer subreads than its record's count", 1)])
def test_a_cluster_missing_a_read_of_its_molecule_is_caught(case, off):
    lib = gen.generate(TINY, 3)
    exp = _expected(lib)
    a, a2 = _reads(lib, 0, 2)
    rec, lane = _clusters(lib, exp, [(a,)])
    lane["umi_reads"][0].append(exp.names[a2])
    lane["umi"][exp.names[a2]] = "ACGT" * 14 + ("ACGTACGA" if "within" in case else "TTTTTTTT")
    if "record" in case:
        lane["umi"][exp.names[a2]] = "TTTT" * 16
        lane["n_of"]["C0"] = 2
    assert judge.judge_members([rec], {0: lane}, exp) == off


def test_the_reads_nearest_the_ee_limit_are_sampled():
    extra = {"per_molecule": [2, 2], "truncated_share": 0.5, "truncated_len": [500, 900],
             "quality_shift": [3.0, 7.0]}
    lib = gen.generate({**TINY, "extra_reads": extra}, 6)
    exp = _expected(lib)
    near = judge.near_limit(lib, exp.knobs, ["A" * 47], 3)
    out = ref.assign_reads([lib.reads[i][1] for i in range(len(lib.reads))],
                           [lib.reads[i][2] for i in range(len(lib.reads))], exp.knobs,
                           ["A" * 47])
    rates = np.array([o["rate"] if len(o["trimmed"]) >= 1470 else np.inf for o in out])
    best = int(np.argmin(np.abs(rates - 0.07)))
    assert best in near and all(len(lib.reads[i][1]) > 1470 for i in near)


def test_a_consensus_finds_its_molecule_through_an_indel():
    lib = gen.generate({**TINY, "molecules_per_region": [30, 30]}, 4)
    exp = _expected(lib)
    mol = lib.molecules[7]
    body = lib.reference[mol.region]
    seq = mol.umi_fwd[:10] + mol.umi_fwd[11:] + body + mol.umi_rev
    cands = np.array([i for i, m in enumerate(lib.molecules) if m.region == mol.region])
    assert exp.match_molecule(seq, cands) == 7
    shifted = "G" + mol.umi_fwd[:20] + mol.umi_fwd[21:] + body + mol.umi_rev[:-1]
    assert exp.match_molecule(shifted, cands) == 7
    assert exp.match_molecule("A" * 32 + body + "C" * 32, cands) is None


def test_pileup_and_vote_equal_the_plain_twins():
    from ont_tcrconsensus_tpu_torch.ops import consensus, pileup

    lib = gen.generate({**TINY, "region_len": [300, 340]}, 5)
    S, W = 6, 512
    sub = np.full((2, S, W), ref.PAD_CODE, np.uint8)
    lens = np.zeros((2, S), np.int32)
    for c in range(2):
        for r, i in enumerate(np.where(lib.read_mol == c)[0][:S]):
            s = ref.revcomp(lib.reads[i][1]) if lib.read_rev[i] else lib.reads[i][1]
            sub[c, r, : len(s)] = ref.encode(s)
            lens[c, r] = len(s)
    drafts = np.where(np.arange(W)[None] < lens[:, :1], sub[:, 0], ref.PAD_CODE).astype(np.uint8)
    ours = ref.pileup(sub, lens, drafts, lens[:, 0].copy(), 64)
    theirs = pileup.pileup_columns_batch_auto(
        torch.from_numpy(sub), torch.from_numpy(lens), torch.from_numpy(drafts),
        torch.from_numpy(lens[:, 0].copy()), band_width=64, out_len=W)
    for a, b in zip(ours[:3], theirs[:3]):
        assert torch.equal(a, b)
    assert np.array_equal(ours[3], theirs[4].numpy())
    d, dl, _ = ref.vote_consensus(sub, lens, 4, 64)
    d2, dl2 = consensus.consensus_clusters_batch(sub, lens, rounds=4, band_width=64, device="cpu")
    assert np.array_equal(d, d2) and np.array_equal(dl, dl2)
