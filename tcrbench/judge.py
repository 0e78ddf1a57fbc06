"""The comparison that decides ``correct``: each lane's outputs read back
from its ``nano_tcr/`` tree and held to the plain reference
(:mod:`tcrbench.reference`) and to the generator's truth.

Numbers, each summed (or, for a gap, maximized) over the window's lanes:

- ``assign_off``: sampled reads (drawn from the seed, and those whose EE
  rate lies nearest the filter's limit) whose round-1 outcome differs from
  the reference's: kept or dropped (a read whose rate ties the limit at
  float32 rounding may go either way), strand, trimmed sequence, region
  cluster (the panel's clusters worked out again), UMI record and fields;
- ``clusters_off``: clusters of the recorded polish tiles that are not
  one molecule's, whole: a subread of another molecule or of no kept
  read, a subread count other than its consensus record's member count,
  or a read of the molecule left out whose UMI lies within the identity
  of every member's;
- ``round2_off``: molecules without exactly one round-1 consensus,
  consensus records matching no molecule, in another region cluster, or
  called to another region in round 2;
- ``counts_off``: the counts CSV against the truth, region by region;
- ``consensus_off``: sampled clusters of the window's polish tiles whose
  consensus, recomputed from the same subreads (vote rounds, then under
  ``rnn`` the polisher), differs from the one the polish returned or is
  not a record of the lane's ``merged_consensus.fasta``;
- ``polisher_conf_gap`` (``rnn``): the widest gap between the program's
  confidence (the softmax probability of the best class, and of the best
  insertion, that the polisher's gate compares with ``min_confidence``)
  and the reference's, over the sampled clusters' covered draft
  positions.
"""

from __future__ import annotations

import csv
import json
import os
import re

import numpy as np
import torch

from tcrbench import reference as ref

UMI_K = 12
_CONS_HEADER = re.compile(r"^region_cluster(\d+)_cluster(\d+)_(\d+)$")


def _fasta(path: str):
    """(header, sequence) records of a FASTA file."""
    with open(path) as fh:
        header, parts = None, []
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if header is not None:
                    yield header, "".join(parts)
                header, parts = line[1:], []
            else:
                parts.append(line)
        if header is not None:
            yield header, "".join(parts)


class Expected:
    """What the reference works out once per run, from the library alone."""

    def __init__(self, lib, knobs: dict, primers: list[str], sample: np.ndarray,
                 weights_path: str | None):
        self.lib = lib
        self.knobs = knobs
        self.sample = sample
        self.names = [lib.name(i) for i in range(len(lib.reads))]
        self.index = {n: i for i, n in enumerate(self.names)}
        self.cluster_of = ref.region_clusters(lib.reference, 1.0 - float(knobs["max_ee_rate_base"]))
        sub = [lib.reads[i] for i in sample]
        self.sample_out = ref.assign_reads([s for _, s, _ in sub], [q for _, _, q in sub],
                                           knobs, primers)
        self.params = ref.load_weights(weights_path) if weights_path else None
        # each molecule's UMI k-mers, to find a consensus's molecule
        self.kmer_mols: dict[str, list[int]] = {}
        for m, mol in enumerate(lib.molecules):
            for umi in (mol.umi_fwd, mol.umi_rev):
                for kmer in {umi[i:i + UMI_K] for i in range(len(umi) - UMI_K + 1)}:
                    self.kmer_mols.setdefault(kmer, []).append(m)

    def match_molecule(self, seq: str, candidates: np.ndarray) -> int | None:
        """The molecule among ``candidates`` whose UMI pair the consensus
        carries: of the three sharing the most UMI k-mers with the
        consensus's ends (position-free, so an indel or a shifted end does
        not hide it), the one within 8 edits of both UMIs together (the 8
        bases past each UMI are the region's)."""
        if len(seq) < 64 or not len(candidates):
            return None
        allowed = set(candidates.tolist())
        hits: dict[int, int] = {}
        for end in (seq[:40], seq[-40:]):
            for kmer in {end[i:i + UMI_K] for i in range(len(end) - UMI_K + 1)}:
                for m in self.kmer_mols.get(kmer, ()):
                    if m in allowed:
                        hits[m] = hits.get(m, 0) + 1
        best, best_d = None, 9
        for m in sorted(hits, key=lambda m: (-hits[m], m))[:3]:
            mol = self.lib.molecules[m]
            d = (ref._edit_distance(seq[:40], mol.umi_fwd) + ref._edit_distance(seq[-40:], mol.umi_rev)
                 - 16)
            if d < best_d:
                best, best_d = m, d
        return best


def near_limit(lib, knobs: dict, primers: list[str], n: int) -> np.ndarray:
    """The ``n`` reads whose EE rate lies nearest the filter's limit, on an
    estimate of the trimmed span (the read less its longest primer's
    length at each end), among reads long enough to pass; the sample
    that a change of the filter's precision would show in."""
    cut = max(len(p) for p in primers)
    lens = np.array([len(s) for _, s, _ in lib.reads], np.int64)
    span = lens - 2 * cut
    rate = np.full(len(lens), np.inf)
    for i, (_, _, q) in enumerate(lib.reads):
        if span[i] >= int(knobs["minimal_length"]):
            p = np.frombuffer(q.encode("ascii"), np.uint8)[cut:len(q) - cut].astype(np.float32) - 33
            rate[i] = np.power(np.float32(10), -p / np.float32(10)).sum() / span[i]
    dist = np.abs(rate - float(knobs["max_ee_rate_base"]))
    return np.sort(np.argsort(dist, kind="stable")[:n])


def judge_lane(lane_dir: str, exp: Expected) -> tuple[dict, dict]:
    """The per-lane numbers of one lane's ``nano_tcr/`` tree, and what the
    later comparisons need of it: its kept reads by their subread
    sequence, each molecule's UMI-carrying reads, and its consensus
    records."""
    lib = exp.lib
    lib_dir = os.path.join(lane_dir, "barcode01")
    with open(os.path.join(lane_dir, "region_cluster_dict.json")) as fh:
        region_cluster = json.load(fh)
    regions_of: dict[int, frozenset] = {}
    for region, k in region_cluster.items():
        regions_of[int(k)] = regions_of.get(int(k), frozenset()) | {region}
    # round 1: each kept read's region cluster, strand and trimmed sequence
    placed: dict[str, tuple[int, str, str]] = {}
    rc_dir = os.path.join(lib_dir, "region_cluster_fasta")
    for fname in os.listdir(rc_dir):
        k = int(fname[len("region_cluster"):-len(".fasta")])
        for header, seq in _fasta(os.path.join(rc_dir, fname)):
            name, _, strand = header.partition(";strand=")
            placed[name] = (k, strand, seq)
    umi_recs: dict[str, tuple] = {}
    combined: dict[str, str] = {}
    umi_dir = os.path.join(lib_dir, "umi_fasta")
    for fname in os.listdir(umi_dir):
        for header, umi in _fasta(os.path.join(umi_dir, fname)):
            f = dict(p.split("=", 1) for p in header.split(";seq=", 1)[0].split(";")[1:])
            name = header.split(";", 1)[0]
            umi_recs[name] = (int(f["umi_fwd_dist"]), int(f["umi_rev_dist"]), f["umi_fwd_seq"],
                              f["umi_rev_seq"])
            combined[name] = umi
    assign_off = 0
    for i, out in zip(exp.sample, exp.sample_out):
        name = exp.names[i]
        got = placed.get(name)
        if got is None or not out["pass"]:
            if (got is None) != (not out["pass"]) and not out["tie"]:
                assign_off += 1
                continue
            if got is None:
                continue
        k, strand, seq = got
        truth_region = lib.molecules[lib.read_mol[i]].region
        ok = (strand == ("-" if lib.read_rev[i] else "+") and seq == out["trimmed"]
              and regions_of.get(k) == exp.cluster_of[truth_region]
              and umi_recs.get(name) == out["umi"])
        assign_off += not ok
    # round-1 consensus records and their round-2 region calls
    round2_region: dict[str, str] = {}
    rf_dir = os.path.join(lib_dir, "region_fasta")
    if os.path.isdir(rf_dir):
        for fname in os.listdir(rf_dir):
            region = fname[len("region_"):-len(".fasta")]
            for header, _ in _fasta(os.path.join(rf_dir, fname)):
                round2_region[header.split(";", 1)[0]] = region
    mol_region = np.array([m.region for m in lib.molecules])
    per_mol = np.zeros(len(lib.molecules), np.int64)
    round2_off = 0
    n_of: dict[str, int] = {}    # each consensus record's member count, by its sequence
    merged = os.path.join(lib_dir, "fasta", "merged_consensus.fasta")
    for header, seq in (_fasta(merged) if os.path.exists(merged) else ()):
        m = _CONS_HEADER.match(header.split(";", 1)[0])
        n_of[seq] = int(m.group(3)) if m else -1
        members = regions_of.get(int(m.group(1)), frozenset()) if m else frozenset()
        cands = np.where(np.isin(mol_region, list(members)))[0]
        mol = exp.match_molecule(seq, cands)
        if mol is None:
            round2_off += 1
            continue
        per_mol[mol] += 1
        round2_off += round2_region.get(header.split(";", 1)[0]) != lib.molecules[mol].region
    min_reads = int(exp.knobs["min_reads_per_cluster"])
    expected_mols = np.array([m.num_reads >= min_reads for m in lib.molecules])
    round2_off += int((per_mol != expected_mols.astype(np.int64)).sum())
    # the counts
    counts = {}
    with open(os.path.join(lib_dir, "counts", "umi_consensus_counts.csv")) as fh:
        for row in csv.DictReader(fh):
            counts[row["TCR"]] = int(row["Count"])
    truth = true_counts(lib, min_reads)
    counts_off = sum(abs(counts.get(r, 0) - truth.get(r, 0)) for r in set(counts) | set(truth))
    # each kept read by its subread: trimmed, in the molecule's orientation
    oriented = {(ref.revcomp(seq) if strand == "-" else seq): name
                for name, (_, strand, seq) in placed.items()}
    # each molecule's kept reads that carry a UMI record
    umi_reads: dict[int, list[str]] = {}
    for name in combined:
        umi_reads.setdefault(int(lib.read_mol[exp.index[name]]), []).append(name)
    numbers = {"assign_off": assign_off, "round2_off": round2_off, "counts_off": counts_off}
    return numbers, {"oriented": oriented, "umi": combined, "umi_reads": umi_reads,
                     "n_of": n_of}


def judge_members(records: list[dict], lanes: dict[int, dict], exp: Expected) -> int:
    """Clusters of the recorded polish tiles that are not one molecule's,
    whole: a subread that is no kept read of the cluster's molecule; a
    count of subreads other than the member count its consensus record
    carries; or a UMI-carrying read of the molecule left out although its
    combined UMI lies within the configuration's identity of every
    member's (each subread looked up by its sequence among its lane's
    kept reads). The identity is taken by global edit distance, which no
    end-gap allowance lowers, so a read it names would have joined the
    cluster under the program's clustering too; reads whose UMI was
    misread further are left to it."""
    identity = float(exp.knobs["vsearch_identity"])
    cap = int(exp.knobs["max_reads_per_cluster"])
    off = 0
    for rec in records:
        lane = lanes[rec["lane"]]
        sub, lens = np.asarray(rec["sub"]), np.asarray(rec["lens"])
        for c in range(int(rec["C"])):
            names = {lane["oriented"].get(ref.decode(sub[c, r, : lens[c, r]]))
                     for r in np.where(lens[c] > 0)[0]}
            mols = {None if n is None else int(exp.lib.read_mol[exp.index[n]]) for n in names}
            seq = rec["seqs"][c] if isinstance(rec["seqs"][c], str) else ref.decode(rec["seqs"][c])
            if (len(mols) != 1 or None in mols
                    or lane["n_of"].get(seq) != int((lens[c] > 0).sum())):
                off += 1
                continue
            umis = [lane["umi"][n] for n in names]
            left = [n for n in lane["umi_reads"].get(mols.pop(), ()) if n not in names]
            off += len(names) < cap and any(
                all(_identity(lane["umi"][n], u) >= identity for u in umis) for n in left)
    return off


def _identity(a: str, b: str) -> float:
    return 1.0 - ref._edit_distance(a, b) / max(len(a), len(b), 1)


def true_counts(lib, min_reads: int) -> dict[str, int]:
    """Molecules of at least ``min_reads`` reads, by region. A molecule's
    extras (reads the filter may drop) must not decide its count."""
    counts: dict[str, int] = {}
    for m in lib.molecules:
        if m.num_reads < min_reads <= m.num_reads + len(m.extras):
            raise ValueError("a molecule's extra reads decide whether it is counted")
        if m.num_reads >= min_reads:
            counts[m.region] = counts.get(m.region, 0) + 1
    return counts


def judge_polish(records: list[dict], lanes: dict[int, dict], exp: Expected,
                 rng: np.random.Generator, n_clusters: int) -> dict:
    """``consensus_off`` and, with a polisher, ``polisher_conf_gap`` over
    ``n_clusters`` clusters drawn from the recorded tiles, the costliest
    one (most subread bases) always among them: each recomputed consensus
    is what the polish returned and a record of its lane's merged
    consensus FASTA."""
    pool = []
    for t, rec in enumerate(records):
        lens = np.asarray(rec["lens"])
        for c in range(int(rec["C"])):
            if (lens[c] > 0).any():
                pool.append((t, c, int(lens[c].sum())))
    if not pool:
        return {"consensus_off": 0, "clusters_checked": 0}
    costly = max(range(len(pool)), key=lambda p: pool[p][2])
    rest = [p for p in range(len(pool)) if p != costly]
    picks = [costly] + [int(x) for x in rng.choice(rest, size=min(n_clusters - 1, len(rest)),
                                                   replace=False)]
    by_shape: dict[tuple, list] = {}
    for p in picks:
        t, c, _ = pool[p]
        rec = records[t]
        by_shape.setdefault((np.asarray(rec["sub"]).shape[2], rec["band"], rec["rounds"]),
                            []).append((t, c))
    consensus_off, gap = 0, 0.0
    for (Wd, band, rounds), items in by_shape.items():
        s_max = max(int((np.asarray(records[t]["lens"])[c] > 0).sum()) for t, c in items)
        sub = np.full((len(items), s_max, Wd), ref.PAD_CODE, np.uint8)
        slens = np.zeros((len(items), s_max), np.int32)
        for r, (t, c) in enumerate(items):
            lens = np.asarray(records[t]["lens"])[c]
            rows = np.where(lens > 0)[0]
            sub[r, : len(rows)] = np.asarray(records[t]["sub"])[c, rows]
            slens[r, : len(rows)] = lens[rows]
        drafts, dlens, piles = ref.vote_consensus(sub, slens, rounds, band)
        for r, (t, c) in enumerate(items):
            rec = records[t]
            live = int((slens[r] > 0).sum())
            want = drafts[r, : dlens[r]]
            if exp.params is not None:
                base_at, ins_cnt, ins_base = piles[r]
                feats = ref.features(base_at, ins_cnt, ins_base, drafts[r])[None]
                with torch.no_grad():
                    logits = ref.polisher_logits(exp.params, feats)[0]
                pred, conf, ins_pred, ins_conf = ref.decisions(logits)
                depth = (base_at != ref.UNCOVERED).sum(dim=0).numpy()
                want = ref.splice(drafts[r], int(dlens[r]), live, pred, conf, depth, ins_pred,
                                  ins_conf, float(exp.knobs["min_confidence"]),
                                  int(exp.knobs["min_polish_depth"]))
                g_conf, g_ins_conf = rec["conf"][c], rec["ins_conf"][c]
                got = _codes(rec["seqs"][c])
                if not np.array_equal(np.asarray(rec["drafts"][c][: rec["dlens"][c]]),
                                      drafts[r, : dlens[r]]):
                    consensus_off += 1  # the vote differs: positions do not line up
                    continue
                served = (np.arange(drafts.shape[1]) < dlens[r]) & (depth > 0)
                if served.any():
                    gap = max(gap, float(np.abs(np.asarray(g_conf)[served] - conf[served]).max()),
                              float(np.abs(np.asarray(g_ins_conf)[served]
                                           - ins_conf[served]).max()))
            else:
                got = _codes(rec["seqs"][c])
            consensus_off += (not np.array_equal(np.asarray(got, np.uint8), want)
                              or ref.decode(want) not in lanes[rec["lane"]]["n_of"])
    out = {"consensus_off": consensus_off, "clusters_checked": len(picks)}
    if exp.params is not None:
        out["polisher_conf_gap"] = gap
    return out


def _codes(seq) -> np.ndarray:
    if isinstance(seq, str):
        return ref.encode(seq)
    return np.asarray(seq, np.uint8)
