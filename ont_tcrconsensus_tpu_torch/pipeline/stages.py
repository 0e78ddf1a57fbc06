"""Pipeline stages over the columnar read store.

The counterpart of the JAX package's ``pipeline/stages.py`` (host logic
copied; device passes in PyTorch on the run's device, the card unless the
caller names the CPU): grouping, UMI record assembly, clustering + subread
selection with the sub-threshold rescue, batched consensus polish (vote
rounds, then the optional bi-GRU polisher) with the out-of-memory shrink
ladder, and counting. Strings materialize only at artifact boundaries.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import defaultdict

import numpy as np
import torch

from ont_tcrconsensus_tpu_torch.cluster import umi as umi_mod
from ont_tcrconsensus_tpu_torch.device import resolve_device
from ont_tcrconsensus_tpu_torch.io import bucketing, fastx
from ont_tcrconsensus_tpu_torch.ops import consensus as consensus_mod
from ont_tcrconsensus_tpu_torch.ops import edit_distance, encode, sketch
from ont_tcrconsensus_tpu_torch.pipeline.assign import ReadStore, ReferencePanel
from ont_tcrconsensus_tpu_torch.robustness import contracts, retry

# ---------------------------------------------------------------------------
# stage: UMI record assembly


@dataclasses.dataclass
class UmiRecord:
    """One read's extracted UMI pair + a (block, row) handle into the store."""

    name: str
    strand: str
    umi_fwd_dist: int
    umi_rev_dist: int
    umi_fwd_seq: str
    umi_rev_seq: str
    combined: str          # canonical (molecule) orientation
    block: int
    row: int

    def header(self, store: ReadStore) -> str:
        """7-field header of the reference's UMI fasta (the full read in
        ``seq=``)."""
        seq = store.blocks[self.block].decode_one(self.row)
        return (
            f"{self.name};strand={self.strand};umi_fwd_dist={self.umi_fwd_dist};"
            f"umi_rev_dist={self.umi_rev_dist};umi_fwd_seq={self.umi_fwd_seq};"
            f"umi_rev_seq={self.umi_rev_seq};seq={seq}"
        )


def build_umi_records(store: ReadStore, parts: list[tuple[int, np.ndarray]],
                      max_pattern_dist: int) -> list[UmiRecord]:
    """UMI records for one read group from the fused-pass fields.

    Combined UMI canonicalization: '+' -> fwd+rev, '-' ->
    revcomp(rev)+revcomp(fwd). Reads where either pattern exceeds
    ``max_pattern_dist`` are dropped (the edlib k gate).
    """
    out: list[UmiRecord] = []
    for bi, rows in parts:
        blk = store.blocks[bi]
        u = blk.umi
        ok = (u["d5"][rows] <= max_pattern_dist) & (u["d3"][rows] <= max_pattern_dist)
        ok &= (u["e5"][rows] > u["s5"][rows]) & (u["e3"][rows] > u["s3"][rows])
        ascii_rows = encode._DECODE_ASCII[blk.codes[rows]]
        for k, r in enumerate(rows):
            if not ok[k]:
                continue
            s5, e5 = int(u["s5"][r]), int(u["e5"][r])
            a3 = int(u["start3"][r])
            s3, e3 = a3 + int(u["s3"][r]), a3 + int(u["e3"][r])
            u5 = ascii_rows[k, s5:e5].tobytes().decode("ascii")
            u3 = ascii_rows[k, s3:e3].tobytes().decode("ascii")
            strand = "-" if blk.is_rev[r] else "+"
            if strand == "+":
                combined = u5 + u3
            else:
                combined = encode.revcomp_str(u3) + encode.revcomp_str(u5)
            out.append(UmiRecord(
                name=blk.names[r], strand=strand,
                umi_fwd_dist=int(u["d5"][r]), umi_rev_dist=int(u["d3"][r]),
                umi_fwd_seq=u5, umi_rev_seq=u3,
                combined=combined, block=bi, row=int(r),
            ))
    return out


def write_umi_fasta(records: list[UmiRecord], store: ReadStore, path: str) -> int:
    """The 'UMI fasta': combined UMI as sequence, full read in the header."""
    return fastx.write_fasta(path, ((r.header(store), r.combined) for r in records))


# ---------------------------------------------------------------------------
# stage: region grouping + per-group fasta artifacts


def group_by_region_cluster(store: ReadStore, panel: ReferencePanel):
    """Round-1 grouping: {cluster_id: [(block, rows)]}."""
    return store.group_rows_by(panel.cluster_of_region)


def group_by_region(store: ReadStore, panel: ReferencePanel):
    """Round-2 grouping: {region_name: [(block, rows)]}."""
    idx_groups = store.group_rows_by(np.arange(len(panel.names), dtype=np.int32))
    return {panel.names[k]: v for k, v in idx_groups.items()}


def write_region_fastas(groups: dict, store: ReadStore, out_dir: str, prefix: str) -> None:
    """Per-group fastas: original-orientation sequence, header
    ``<name>;strand=<+/->``."""
    for key, parts in sorted(groups.items(), key=lambda kv: str(kv[0])):
        def rows_iter(parts=parts):
            for bi, rows in parts:
                blk = store.blocks[bi]
                seqs = blk.decode(rows)
                for k, r in enumerate(rows):
                    strand = "-" if blk.is_rev[r] else "+"
                    yield f"{blk.names[r]};strand={strand}", seqs[k]

        fastx.write_fasta(os.path.join(out_dir, f"{prefix}{key}.fasta"), rows_iter())


# ---------------------------------------------------------------------------
# stage: UMI clustering + subread selection


@dataclasses.dataclass
class SelectedCluster:
    cluster_id: int
    members: list[UmiRecord]       # the selected subreads (<= max)
    n_fwd: int
    n_rev: int
    written_fwd: int
    written_rev: int
    n_found: int


def cluster_and_select_grouped(
    named_records: list[tuple[str, list[UmiRecord]]],
    identity: float,
    min_umi_length: int,
    max_umi_length: int,
    min_reads_per_cluster: int,
    max_reads_per_cluster: int,
    balance_strands: bool,
    device: str | torch.device | None = None,
) -> dict[str, tuple[list[SelectedCluster], list[dict]]]:
    """Cluster every group's combined UMIs in one batched pass (cross-group
    identities masked), select subreads per group, then heal sub-threshold
    fragments with one batched rescue pass, on ``device`` (the card when
    None). Returns {group: (selected, stat_rows)}."""
    device = resolve_device(device)
    eligibles = [
        (name, [r for r in records if min_umi_length <= len(r.combined) <= max_umi_length])
        for name, records in named_records
    ]
    groups = [[r.combined for r in recs] for _, recs in eligibles]
    clusters_list = umi_mod.cluster_umis_grouped(groups, identity, device=device)
    out: dict[str, tuple[list[SelectedCluster], list[dict]]] = {}
    rescue_work: list[tuple] = []
    first_pass: dict[str, tuple] = {}
    for (name, recs), clusters in zip(eligibles, clusters_list):
        if not recs:
            out[name] = ([], [])
            continue
        members = _group_members(recs, clusters.labels)
        selected, stat_rows, taken = _run_selection(
            members, min_reads_per_cluster, max_reads_per_cluster, balance_strands,
        )
        first_pass[name] = (recs, clusters, selected, stat_rows)
        if min_reads_per_cluster > 1:
            rescue_work.append((name, recs, clusters, members, taken))
    roots_by = _rescue_grouped(rescue_work, identity, device) if rescue_work else {}
    for name, (recs, clusters, selected, stat_rows) in first_pass.items():
        roots = roots_by.get(name)
        if roots is not None:
            selected, stat_rows, _ = _run_selection(
                _group_members(recs, clusters.labels, roots),
                min_reads_per_cluster, max_reads_per_cluster, balance_strands,
            )
        # UMI conservation: the rescue relabels clusters but never creates
        # or loses members
        contracts.check_equal(
            "umi", "cluster-stats member total", sum(r["n"] for r in stat_rows),
            "eligible UMI records", len(recs), detail={"group": name},
        )
        out[name] = (selected, stat_rows)
    return out


#: relaxed dovetail free-end budget for the second-chance UMI pass
RESCUE_K_END = 16


def _rescue_identities(codes, lens, sub_global, gid, rescue_k_end, device):
    """(n_sub, K+1) candidate centroid indices + relaxed-end identities:
    k-mer shortlist over ALL centroid rows, then exact dovetail distances
    with ``rescue_k_end`` free ends. Self, padded and (with ``gid``)
    cross-group entries are forced to identity -1."""
    n_all = codes.shape[0]
    n_pad = bucketing.pow2_ceil(n_all, 16)
    if n_pad > n_all:
        codes = np.concatenate([codes, np.zeros((n_pad - n_all, codes.shape[1]), codes.dtype)])
        lens = np.concatenate([lens, np.zeros(n_pad - n_all, lens.dtype)])
    n_sub = len(sub_global)
    q_pad = bucketing.pow2_ceil(n_sub, 16)
    sub_q = np.concatenate(
        [sub_global, np.zeros(q_pad - n_sub, np.int32)]
    ) if q_pad > n_sub else np.asarray(sub_global, np.int32)
    t_codes = torch.from_numpy(codes).to(device)
    t_lens = torch.from_numpy(lens).to(device)
    profiles = sketch.kmer_profile(t_codes, t_lens, k=4, dim=None)
    K = min(8, n_all - 1)
    q_idx = torch.from_numpy(sub_q.astype(np.int64)).to(device)
    cand = sketch.top_candidates(profiles[q_idx], profiles, K + 1).cpu().numpy()[:n_sub]
    qi = np.repeat(sub_global, K + 1)
    ti = cand.reshape(-1).astype(np.int32)
    n_pairs = len(qi)
    n_padded = bucketing.pow2_ceil(n_pairs)
    if n_padded > n_pairs:
        pad = n_padded - n_pairs
        qi = np.concatenate([qi, np.zeros(pad, np.int32)])
        ti = np.concatenate([ti, np.zeros(pad, np.int32)])
    t_qi = torch.from_numpy(qi.astype(np.int64)).to(device)
    t_ti = torch.from_numpy(ti.astype(np.int64)).to(device)
    d = edit_distance.pairwise_dovetail(
        t_codes[t_qi], t_lens[t_qi], t_codes[t_ti], t_lens[t_ti], k_end=rescue_k_end,
    ).cpu().numpy().astype(np.float32)[:n_pairs]
    longest = np.maximum(lens[qi[:n_pairs]], lens[ti[:n_pairs]]).astype(np.float32)
    ident = np.where(longest > 0, 1.0 - d / np.maximum(longest, 1.0), -1.0)
    ident = ident.reshape(len(sub_global), K + 1)
    ident[cand == np.asarray(sub_global)[:, None]] = -1.0  # never self-merge
    padded_target = cand >= n_all
    ident[padded_target] = -1.0
    if gid is not None:
        safe_cand = np.where(padded_target, 0, cand)
        ident[gid[safe_cand] != gid[sub_global][:, None]] = -1.0
        ident[padded_target] = -1.0
    return cand, ident


def _rescue_merge_roots(subs, n_c, cand_local, ident, identity, taken):
    """Single-best-edge union-find over one group's clusters; each merged
    component is labeled by its surviving cluster's id when one exists,
    else by its smallest fragment id. {cluster_id: root_id} or None."""
    parent = np.arange(n_c)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    merged = False
    for row, cid in enumerate(subs):
        ok = ident[row] >= identity
        if not ok.any():
            continue
        # single best edge: highest identity, ties -> smaller cluster id
        best_ident = ident[row][ok].max()
        best = int(cand_local[row][ok & (ident[row] >= best_ident)].min())
        a, b = find(cid), find(best)
        if a != b:
            parent[max(a, b)] = min(a, b)
            merged = True
    if not merged:
        return None
    comp_members: dict[int, list[int]] = defaultdict(list)
    for c in range(n_c):
        comp_members[find(c)].append(c)
    label: dict[int, int] = {}
    for root, cs in comp_members.items():
        surv = [c for c in cs if c in taken]
        label[root] = surv[0] if surv else min(cs)
    return {c: label[find(c)] for c in range(n_c)}


def _rescue_subs(members: dict, taken: set) -> list[int]:
    return [cid for cid in sorted(members) if cid not in taken and members[cid]]


def _rescue_grouped(work: list[tuple], identity: float, device,
                    rescue_k_end: int = RESCUE_K_END) -> dict:
    """Second-chance pass for clusters that failed min_reads_per_cluster,
    batched over groups: each sub-threshold cluster's centroid UMI merges
    into its single best match at >= the same identity (ties: smaller
    cluster id). ``work``: [(key, eligible, clusters, members, taken)].
    Returns {key: roots|None}."""
    per_group = []
    cent_all: list[str] = []
    offsets = [0]
    gids: list[int] = []
    subs_global: list[int] = []
    for g, (key, eligible, clusters, members, taken) in enumerate(work):
        subs = _rescue_subs(members, taken)
        n_c = clusters.num_clusters
        s = offsets[-1]
        if not subs or n_c < 2:
            per_group.append((key, None, None, s, taken))
            continue
        cent_all.extend(eligible[int(clusters.centroid_of[c])].combined for c in range(n_c))
        gids.extend([g] * n_c)
        subs_global.extend(s + c for c in subs)
        offsets.append(s + n_c)
        per_group.append((key, subs, n_c, s, taken))
    out = {key: None for key, *_ in per_group}
    if not subs_global or len(cent_all) < 2:
        return out
    codes, lens = encode.encode_batch(cent_all, pad_to=128)
    cand, ident = _rescue_identities(
        codes, lens, np.asarray(subs_global, np.int32), np.asarray(gids, np.int32),
        rescue_k_end, device=device,
    )
    row = 0
    for key, subs, n_c, s, taken in per_group:
        if subs is None:
            continue
        rows = slice(row, row + len(subs))
        row += len(subs)
        cand_local = cand[rows] - s
        ident_g = ident[rows].copy()
        oob = (cand_local < 0) | (cand_local >= n_c)
        cand_local = np.where(oob, 0, cand_local)
        ident_g[oob] = -1.0
        out[key] = _rescue_merge_roots(subs, n_c, cand_local, ident_g, identity, taken)
    return out


def _group_members(eligible, labels, roots=None) -> dict[int, list[UmiRecord]]:
    """Cluster-id -> members in first-come order; ``roots`` remaps ids
    through rescue merges."""
    members: dict[int, list[UmiRecord]] = defaultdict(list)
    for rec, lab in zip(eligible, labels):
        cid = int(lab)
        members[roots[cid] if roots else cid].append(rec)
    return members


def _run_selection(members: dict[int, list[UmiRecord]], min_reads_per_cluster: int,
                   max_reads_per_cluster: int, balance_strands: bool,
                   ) -> tuple[list[SelectedCluster], list[dict], set[int]]:
    """The reference's polish_cluster strand math over one group's member
    map; returns (selected, stats rows, taken ids)."""
    selected: list[SelectedCluster] = []
    stat_rows: list[dict] = []
    taken: set[int] = set()
    for cid in sorted(members):
        mem = members[cid]
        fwd = [m for m in mem if m.strand == "+"]
        rev = [m for m in mem if m.strand == "-"]
        n_fwd, n_rev = len(fwd), len(rev)
        if balance_strands:
            min_fwd = min_rev = min_reads_per_cluster // 2
            max_after = min(n_fwd * 2, n_rev * 2, max_reads_per_cluster)
            max_fwd = max_rev = max_after // 2
        else:
            min_fwd = min_rev = 0
            if n_fwd > n_rev:
                max_rev = min(n_rev, max_reads_per_cluster // 2)
                max_fwd = min(max_reads_per_cluster - max_rev, n_fwd)
            else:
                max_fwd = min(n_fwd, max_reads_per_cluster // 2)
                max_rev = min(max_reads_per_cluster - max_fwd, n_rev)
        n_reads = max_fwd + max_rev
        take = n_fwd >= min_fwd and n_rev >= min_rev and n_reads >= min_reads_per_cluster
        chosen = (fwd[:max_fwd] + rev[:max_rev])[:max_reads_per_cluster] if take else []
        row = {
            "id_cluster": f"cluster{cid}",
            "n_fwd": n_fwd, "n_rev": n_rev,
            "written_fwd": len([m for m in chosen if m.strand == "+"]),
            "written_rev": len([m for m in chosen if m.strand == "-"]),
            "n": len(mem), "written": len(chosen),
            "cluster_written": int(bool(chosen)),
        }
        stat_rows.append(row)
        if chosen:
            taken.add(cid)
            selected.append(SelectedCluster(
                cluster_id=cid, members=chosen, n_fwd=n_fwd, n_rev=n_rev,
                written_fwd=row["written_fwd"], written_rev=row["written_rev"],
                n_found=len(mem),
            ))
    return selected, stat_rows, taken


def write_cluster_stats_tsv(stat_rows: list[dict], path: str) -> None:
    """vsearch_cluster_stats.tsv of the reference."""
    cols = ["id_cluster", "n_fwd", "n_rev", "written_fwd", "written_rev",
            "n", "written", "cluster_written"]
    with open(path, "w") as fh:
        fh.write("\t".join(cols) + "\n")
        for row in stat_rows:
            fh.write("\t".join(str(row[c]) for c in cols) + "\n")


# ---------------------------------------------------------------------------
# stage: consensus polishing


def polish_clusters_all(
    selected_by_group: list[tuple[str, list[SelectedCluster]]],
    store: ReadStore,
    max_read_length: int = 4096,
    rounds: int = 4,
    band_width: int = consensus_mod.POLISH_BAND_WIDTH,
    polisher=None,
    cluster_batch: int | None = None,
    budget=None,
    device: str | torch.device | None = None,
) -> dict[str, list[tuple[str, str]]]:
    """Consensus for every selected cluster of every group, batched together,
    on ``device`` (the card when None).

    Subreads are gathered from the store and flipped to canonical (+)
    orientation, their qualities reversed (not complemented) beside them;
    clusters are grouped by (subread-count bucket, width bucket) and
    polished ``cluster_batch`` at a time (from the memory budget unless
    given). ``polisher`` (``models.polisher.make_pipeline_polisher``), when
    given, runs on each chunk after the vote rounds, on their kept final
    pileup. A transient fault retries the chunk on the same device under
    the retry policy; a CUDA out-of-memory error re-derives a smaller batch
    from a halved budget and requeues the chunk and the rest of its bucket;
    results do not depend on the batch. Headers follow the reference's
    ``<group>_cluster<id>_<n_subreads>``. Returns per-group (header, seq)
    lists in cluster-id order.
    """
    device = resolve_device(device)
    prepared: dict[tuple[int, int], list] = defaultdict(list)
    by_group: dict[str, list[tuple[str, str]]] = {g: [] for g, _ in selected_by_group}
    for group_name, selected in selected_by_group:
        for cl in selected:
            rows_codes, rows_rev = [], []
            rows_quals: list | None = []
            max_len = 0
            for m in cl.members:
                blk = store.blocks[m.block]
                ln = int(blk.lens[m.row])
                c = blk.codes[m.row, :ln]
                q = blk.quals[m.row, :ln] if blk.quals is not None else None
                if m.strand == "-":
                    c = encode.revcomp_codes(c)
                    q = q[::-1] if q is not None else None  # q[i] stays the phred of base i
                rows_codes.append(c)
                if q is None:
                    rows_quals = None
                elif rows_quals is not None:
                    rows_quals.append(q)
                rows_rev.append(m.strand == "-")
                max_len = max(max_len, ln)
            # one lane-width of growth slack above the longest subread
            need = max_len + 128
            width = min(
                max_read_length,
                next((w for w in bucketing.DEFAULT_WIDTHS if w >= need), max_read_length),
            )
            codes, lens = encode.pad_batch(rows_codes, pad_to=width, multiple=128)
            s_bucket = bucketing.pow2_ceil(len(rows_codes))
            quals = None
            if rows_quals is not None:
                quals = np.zeros((s_bucket, codes.shape[1]), np.uint8)
                for i, q in enumerate(rows_quals):
                    quals[i, : len(q)] = q
            strands = np.zeros(s_bucket, bool)
            strands[: len(rows_rev)] = rows_rev
            if s_bucket > len(rows_codes):
                pad_rows = s_bucket - len(rows_codes)
                codes = np.concatenate(
                    [codes, np.full((pad_rows, codes.shape[1]), encode.PAD_CODE, np.uint8)]
                )
                lens = np.concatenate([lens, np.zeros(pad_rows, lens.dtype)])
            prepared[(s_bucket, codes.shape[1])].append(
                (group_name, cl, codes, lens, quals, strands)
            )

    keep_pos = bool(getattr(polisher, "wants_v4", False))
    for (s_bucket, width), items in sorted(prepared.items()):
        # long-amplicon buckets double the band: indel drift grows with length
        eff_band = band_width if width <= 2048 else max(band_width, 128)
        if cluster_batch is not None:
            cb = cluster_batch
        elif budget is not None:
            cb = budget.cluster_batch(s_bucket, width, eff_band,
                                      keep_final_pileup=polisher is not None,
                                      keep_pos=keep_pos)
        else:
            cb = 16
        cb = min(cb, bucketing.pow2_ceil(len(items)))
        worklist: list[tuple[list, int, int]] = [(items, cb, 0)]
        while worklist:
            run_items, cb_run, shrink = worklist.pop(0)
            for start in range(0, len(run_items), cb_run):
                chunk = run_items[start : start + cb_run]
                seqs = _dispatch_polish_retried(
                    chunk, cb_run, s_bucket, width, shrink, rounds=rounds, eff_band=eff_band,
                    keep_pos=keep_pos, polisher=polisher, budget=budget, device=device,
                )
                if isinstance(seqs, int):
                    # out of memory: requeue the failing chunk AND the
                    # untried remainder at the smaller batch
                    worklist.append((run_items[start:], seqs, shrink + 1))
                    break
                for c, seq in enumerate(seqs):
                    group_name, cl = chunk[c][0], chunk[c][1]
                    by_group[group_name].append(
                        (f"{group_name}_cluster{cl.cluster_id}_{len(cl.members)}", seq)
                    )
    for entries in by_group.values():
        entries.sort(key=lambda kv: int(kv[0].rsplit("_cluster", 1)[1].split("_")[0]))
    return by_group


def _dispatch_polish_retried(chunk, cb_run, s_bucket, width, shrink, *, rounds, eff_band,
                             keep_pos, polisher, budget, device):
    """Dispatch one chunk under the retry policy: the chunk's sequences, or
    the smaller cluster batch to requeue at after an out-of-memory error
    (an int). A transient fault retries the same chunk on the same device;
    every other failure, and an out-of-memory error at a batch that cannot
    shrink, is recorded and raised. Outcomes land in the robustness report
    under ``polish.dispatch``."""
    attempt = 1
    while True:
        try:
            seqs = _dispatch_polish_packed(
                _pack_polish_chunk(chunk, cb_run, s_bucket, width), len(chunk),
                rounds=rounds, eff_band=eff_band, keep_pos=keep_pos,
                polisher=polisher, device=device,
            )
        except Exception as exc:
            pol, rec = retry.policy(), retry.recorder()
            cls = retry.classify(exc)
            if cls == "transient" and attempt < pol.max_attempts:
                rec.record("polish.dispatch", classification=cls, outcome="retried",
                           attempt=attempt, error=repr(exc))
                time.sleep(pol.delay(attempt))
                attempt += 1
                continue
            if cls == "oom":
                new_cb = _shrunken_cluster_batch(
                    budget, shrink, s_bucket, width, eff_band,
                    keep_final=polisher is not None, keep_pos=keep_pos, cb_run=cb_run,
                )
                if new_cb < cb_run:
                    rec.record("polish.dispatch", classification="oom", outcome="oom_shrink",
                               attempt=attempt, error=repr(exc),
                               detail={"cluster_batch_from": cb_run,
                                       "cluster_batch_to": new_cb,
                                       "shrink_level": shrink + 1})
                    if device.type == "cuda":
                        torch.cuda.empty_cache()
                    return new_cb
            rec.record("polish.dispatch", classification=cls,
                       outcome={"oom": "not_retryable", "device_lost": "escalated",
                                "transient": "exhausted"}.get(cls, "fatal"),
                       attempt=attempt, error=repr(exc))
            raise
        if attempt > 1 or shrink:
            retry.recorder().record(
                "polish.dispatch", classification="oom" if shrink else "transient",
                outcome="recovered", attempt=attempt,
                detail={"shrink_level": shrink} if shrink else None,
            )
        return seqs


def _pack_polish_chunk(chunk, cb, s_bucket, width):
    """Stack one chunk into its padded (cb, S, W) tile (cluster axis padded
    with empty clusters): (subreads, lens, quals or None when any cluster
    lacks them, strands)."""
    C = len(chunk)
    sub = np.stack([codes for _, _, codes, _, _, _ in chunk])
    lens = np.stack([ln for _, _, _, ln, _, _ in chunk])
    have_quals = all(q is not None for _, _, _, _, q, _ in chunk)
    quals = np.stack([q for _, _, _, _, q, _ in chunk]) if have_quals else None
    strands = np.stack([s for _, _, _, _, _, s in chunk])
    if C < cb:
        pad = cb - C
        sub = np.concatenate([sub, np.full((pad, s_bucket, width), encode.PAD_CODE, np.uint8)])
        lens = np.concatenate([lens, np.zeros((pad, s_bucket), lens.dtype)])
        if quals is not None:
            quals = np.concatenate([quals, np.zeros((pad, s_bucket, width), np.uint8)])
        strands = np.concatenate([strands, np.zeros((pad, s_bucket), bool)])
    return sub, lens, quals, strands


def _dispatch_polish_packed(packed, C, *, rounds, eff_band, keep_pos, polisher,
                            device) -> list[str]:
    """Consensus (and polish) of one packed (cb, S, W) tile; the C real
    clusters' sequences in chunk order."""
    sub, lens, quals, strands = packed
    drafts, dlens, *rest = consensus_mod.consensus_clusters_batch(
        sub, lens, rounds=rounds, band_width=eff_band,
        keep_final_pileup=polisher is not None, keep_pos=keep_pos, device=device,
    )
    if polisher is not None:
        drafts, dlens = polisher(sub, lens, drafts, dlens, pileup=rest[0],
                                 band_width=eff_band, quals=quals, strands=strands)
    return encode.decode_batch(drafts[:C], dlens[:C])


def _shrunken_cluster_batch(budget, shrink, s_bucket, width, eff_band, *, keep_final,
                            keep_pos, cb_run) -> int:
    """Next cluster batch after the ``shrink``-th out-of-memory error at
    ``cb_run``: the budget model with a halved allowance, strictly below
    ``cb_run``, floor 1 (the ladder always terminates)."""
    if budget is not None:
        shrunk = dataclasses.replace(budget, hbm_gb=budget.hbm_gb / (2.0 ** (shrink + 1)))
        new_cb = shrunk.cluster_batch(s_bucket, width, eff_band,
                                      keep_final_pileup=keep_final, keep_pos=keep_pos)
    else:
        new_cb = cb_run // 2
    return max(1, min(new_cb, cb_run // 2))


# ---------------------------------------------------------------------------
# stage: counting


def write_counts_csv(region_counts: dict[str, int], counts_dir: str,
                     region_name: str = "TCR") -> str:
    """counts/umi_consensus_counts.csv of the reference."""
    path = os.path.join(counts_dir, "umi_consensus_counts.csv")
    with open(path, "w") as fh:
        fh.write(f"{region_name},Count\n")
        for region, count in region_counts.items():
            fh.write(f"{region},{count}\n")
    return path
