"""Fused per-batch read pass + columnar read store.

The counterpart of the JAX package's ``pipeline/assign.py``. One call per
padded read batch runs, on the caller's device:

    primer trim -> EE mask -> k-mer sketch (both strands) -> top-k
    candidates -> banded SW (kernel B1 on the card) -> UMI fuzzy-find in
    both adapter windows

and survivors land in a :class:`ReadStore` of per-width columnar blocks.
Round 1 runs the SW fast path: SW only the needy quarter of each batch
(junk suspects, length-marginal reads, lowest sketch margins) and
synthesize filter-sufficient outputs for the confident rest. Round 2 runs
the targeted pass: each consensus against its own region cluster's
references only.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import torch

from ont_tcrconsensus_tpu_torch.device import resolve_device
from ont_tcrconsensus_tpu_torch.io import bucketing, fastx
from ont_tcrconsensus_tpu_torch.ops import ee_filter, encode, fuzzy_match, sketch, sw_kernel
from ont_tcrconsensus_tpu_torch.ops.sw_align import PAD_SENTINEL
from ont_tcrconsensus_tpu_torch.robustness import contracts

MIN_SCORE = 100  # SW score gate for a "primary alignment" equivalent
BIG_DIST = 1 << 20  # sentinel distance for "no qualifying primer hit"

# round-1 SW fast path (the JAX package's calibration, DIVERGENCES #12)
SW_COS_CONFIDENT = 0.45  # aligned-gate cosine floor for non-SW'd rows
SW_LEN_SLACK_FRAC = 0.02
SW_LEN_SLACK_MIN = 16    # nt floor for very short panels
_NEED_BIG = 1.0e3        # flag weights dominating the margin term

_UMI_KEYS = ("d5", "s5", "e5", "d3", "s3", "e3", "start3")


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# reference panel


@dataclasses.dataclass
class ReferencePanel:
    """Encoded reference regions + sketch profiles, built once per run;
    ``d_*`` are the copies on the run's device."""

    names: list[str]
    seqs: dict[str, str]
    codes: np.ndarray          # (R, Wr) uint8
    lens: np.ndarray           # (R,) int32
    profiles: np.ndarray       # (R, dim) float32
    region_cluster: dict[str, int]
    cluster_of_region: np.ndarray  # (R,) int32 — region idx -> cluster id
    d_codes: torch.Tensor = dataclasses.field(repr=False, default=None)
    d_lens: torch.Tensor = dataclasses.field(repr=False, default=None)
    d_profiles: torch.Tensor = dataclasses.field(repr=False, default=None)

    @classmethod
    def build(cls, reference: dict[str, str], region_cluster: dict[str, int],
              device: str | torch.device | None = None,
              pad_multiple: int = 128) -> "ReferencePanel":
        """The panel of ``reference``, its device copies on ``device`` (the
        card when None)."""
        device = resolve_device(device)
        names = list(reference)
        max_len = max(len(s) for s in reference.values())
        codes, lens = encode.encode_batch([reference[n] for n in names], pad_to=max_len,
                                          multiple=pad_multiple)
        d_codes = torch.from_numpy(codes).to(device)
        d_lens = torch.from_numpy(lens).to(device)
        d_profiles = sketch.kmer_profile(d_codes, d_lens)
        return cls(
            names=names, seqs=dict(reference), codes=codes, lens=lens,
            profiles=d_profiles.cpu().numpy(), region_cluster=dict(region_cluster),
            cluster_of_region=np.array([region_cluster[n] for n in names], dtype=np.int32),
            d_codes=d_codes, d_lens=d_lens, d_profiles=d_profiles,
        )


# ---------------------------------------------------------------------------
# the device passes


def _mask_windows(codes, starts, width: int, limit: int):
    """(B, width) IUPAC masks of ``codes[b, starts[b] + p]`` for p < limit
    (0 beyond), positions clamped into the row."""
    W = codes.shape[1]
    pos = torch.arange(width, device=codes.device, dtype=torch.int64)[None, :]
    idx = (starts.to(torch.int64)[:, None] + pos).clamp(0, W - 1)
    c2m = torch.from_numpy(encode.CODE_TO_MASK).to(codes.device)
    masks = c2m[codes.gather(1, idx).long()]
    return torch.where(pos < limit, masks, torch.zeros_like(masks))


def _umi_windows(codes, lens_t, t_start, umi_masks, umi_mask_lens, *, a5: int, a3: int) -> dict:
    """Fwd/rev UMI pattern search in both adapter windows.

    Window budgets are fixed in the physical read frame, strand-independent
    (the reference slices ``seq[:a5]`` / ``seq[-a3:]`` of the
    sequencer-orientation read), so the mutually-revcomp UMI patterns keep
    the search strand-agnostic.
    """
    B = codes.shape[0]
    aw = max(a5, a3)
    w5 = _mask_windows(codes, t_start, aw, a5)
    l5 = lens_t.clamp(max=a5)
    start3 = (lens_t - a3).clamp(min=0)  # trimmed-frame coords (downstream)
    w3 = _mask_windows(codes, t_start + start3, aw, a3)
    l3 = lens_t.clamp(max=a3)
    ud, us, ue = fuzzy_match.fuzzy_find_multi(
        umi_masks, umi_mask_lens, torch.cat([w5, w3]), torch.cat([l5, l3]),
    )  # each (2, 2B)
    return {
        "d5": ud[0, :B], "s5": us[0, :B], "e5": ue[0, :B],
        "d3": ud[1, B:], "s3": us[1, B:], "e3": ue[1, B:],
        "start3": start3,
    }


def _sw_pass(ref_codes, ref_lens, band_width, a5, a3,
             codes_in, lens_in, lens_t_in, t_start_in, a5_in, a3_in, ridx) -> dict:
    """Banded SW of each read against ``ridx``'s reference, the band
    centred from the amplicon geometry (a one-sided trim anchors the
    trusted side, capped at that side's softclip budget)."""
    rl = ref_lens[ridx.long()]
    margin = lens_t_in - rl
    half = torch.div(margin, 2, rounding_mode="floor")
    cap5 = half.clamp(max=a5)
    cap3 = half.clamp(max=a3)
    m5 = torch.where(a5_in, cap5, torch.where(a3_in, margin - cap3, half))
    offs = (-t_start_in - m5).to(torch.int32)
    res = sw_kernel.align_banded_auto(
        codes_in, lens_in, ref_codes[ridx.long()], rl, offs, band_width=band_width,
    )
    return {
        "score": res.score, "ridx": ridx.to(torch.int32).clone(),
        "ref_start": res.ref_start, "ref_end": res.ref_end,
        "read_start": res.read_start, "read_end": res.read_end,
        "n_match": res.n_match, "n_cols": res.n_cols,
    }


def _fused_pass(codes, quals, lens, ref_codes, ref_lens, ref_profiles,
                umi_masks, umi_mask_lens, primer_stack, primer_stack_lens,
                primer_max_dists, max_ee_rate: float, min_len: int,
                overlap_frac: float, *, top_k: int, band_width: int, a5: int,
                a3: int, trim_window: int, n_primers: int,
                sw_subset_denom: int = 0) -> dict:
    """Trim + filter + assign + UMI-locate one batch (all tensors on one
    device). ``primer_stack`` is (2P, m): P forward primers then their P
    reverse complements; ``quals`` None for FASTA input."""
    B, W = codes.shape
    dev = codes.device
    lens = lens.to(torch.int32)

    # --- primer trim (dorado trim analogue) ---
    t_start = torch.zeros((B,), dtype=torch.int32, device=dev)
    t_end = lens
    if n_primers:
        P = n_primers
        tw = min(trim_window, W)
        start3w = (lens - tw).clamp(min=0)
        w5 = _mask_windows(codes, torch.zeros_like(lens), tw, tw)
        w3 = _mask_windows(codes, start3w, tw, tw)
        wlen = lens.clamp(max=tw)
        d, s, e = fuzzy_match.fuzzy_find_multi(
            primer_stack, primer_stack_lens, torch.cat([w5, w3]), torch.cat([wlen, wlen]),
        )  # each (2P, 2B)
        pmax = primer_max_dists[:, None]
        # among qualifying primers the smallest distance wins, ties to the
        # earliest primer
        d5p = torch.where(d[:P, :B] <= pmax, d[:P, :B], BIG_DIST)
        p5 = torch.argmin(d5p, dim=0)[None, :]
        hit5 = d5p.gather(0, p5)[0] < BIG_DIST
        best_e5 = e[:P, :B].gather(0, p5)[0]
        d3p = torch.where(d[P:, B:] <= pmax, d[P:, B:], BIG_DIST)
        p3 = torch.argmin(d3p, dim=0)[None, :]
        hit3 = d3p.gather(0, p3)[0] < BIG_DIST
        best_s3 = s[P:, B:].gather(0, p3)[0]
        t_start = torch.where(hit5, best_e5, 0).to(torch.int32)
        t_end = torch.where(hit3, start3w + best_s3, lens).to(torch.int32)
        t_end = torch.maximum(t_end, t_start)

    # the trim is virtual: only the [t_start, t_end) span bounds move
    lens_t = t_end - t_start

    # --- EE / length filter ---
    if quals is not None:
        ee_ok = ee_filter.ee_rate_mask_span(quals, t_start, t_end, max_ee_rate, min_len)
    else:
        ee_ok = lens_t >= min_len

    # --- sketch candidates + strand, on the untrimmed read ---
    cand_idx, cand_scores, is_rev = sketch.candidates_both_strands(
        codes, lens, ref_profiles, top_k_=top_k
    )
    oriented = torch.where(is_rev[:, None], sketch.revcomp_batch(codes, lens), codes)
    t_start_o = torch.where(is_rev, lens - t_end, t_start)

    # band-centring anchors for one-sided primer trims (in the oriented frame)
    if n_primers:
        b5, b3 = hit5 & ~hit3, hit3 & ~hit5
        anchor5 = torch.where(is_rev, b3, b5)
        anchor3 = torch.where(is_rev, b5, b3)
    else:
        anchor5 = anchor3 = torch.zeros((B,), dtype=torch.bool, device=dev)

    # bases outside the trimmed span never match (SW soft-clips them)
    pos_full = torch.arange(W, device=dev, dtype=torch.int32)[None, :]
    in_span = (pos_full >= t_start_o[:, None]) & (pos_full < (t_start_o + lens_t)[:, None])
    oriented_sw = torch.where(in_span, oriented, PAD_SENTINEL).to(torch.uint8)

    def sw_pass(*args):
        return _sw_pass(ref_codes, ref_lens, band_width, a5, a3, *args)

    if sw_subset_denom > 0 and top_k == 2:
        # fast path: SW only the needy subset, synthesize the rest
        k_sw = min(B, max(B // sw_subset_denom, 8))
        cos1 = cand_scores[:, 0]
        margin = cand_scores[:, 0] - cand_scores[:, 1]
        rl1 = ref_lens[cand_idx[:, 0].long()]
        est_start = torch.minimum(
            torch.div(rl1 - lens_t, 2, rounding_mode="floor").clamp(min=0), rl1
        )
        est_end = torch.minimum(est_start + lens_t, rl1)
        est_span = (est_end - est_start).to(torch.float32)
        rl1_f = rl1.to(torch.float32)
        min_span = rl1_f * _f32(overlap_frac, dev)
        slack = torch.maximum(rl1_f * _f32(SW_LEN_SLACK_FRAC, dev), _f32(SW_LEN_SLACK_MIN, dev))
        length_marginal = (est_span - min_span).abs() <= slack
        junk_suspect = cos1 < _f32(SW_COS_CONFIDENT, dev)
        need = (
            -margin
            + torch.where(length_marginal, _f32(_NEED_BIG, dev), _f32(0.0, dev))
            + torch.where(junk_suspect, _f32(2.0 * _NEED_BIG, dev), _f32(0.0, dev))
        )
        # padding rows and EE/length failures never displace needy rows
        need = torch.where(ee_ok & (lens_t > 0), need, _f32(-3.0 * _NEED_BIG, dev))
        sw_rows = sketch.top_k(need, k_sw)[1]

        sub_args = tuple(x[sw_rows] for x in (oriented_sw, lens, lens_t, t_start_o,
                                              anchor5, anchor3))
        sub_best = sw_pass(*sub_args, cand_idx[sw_rows, 0])
        sub_cur = sw_pass(*sub_args, cand_idx[sw_rows, 1])
        better = sub_cur["score"] > sub_best["score"]
        sub_best = {k: torch.where(better, sub_cur[k], sub_best[k]) for k in sub_best}

        zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
        best = {
            "score": torch.where(cos1 >= _f32(SW_COS_CONFIDENT, dev), MIN_SCORE, -1).to(torch.int32),
            "ridx": cand_idx[:, 0].clone(),
            "ref_start": est_start.to(torch.int32),
            "ref_end": est_end.to(torch.int32),
            "read_start": zeros.clone(),
            "read_end": lens_t.clone(),
            "n_match": zeros.clone(),
            "n_cols": zeros.clone(),
        }
        for k in best:
            best[k][sw_rows] = sub_best[k].to(torch.int32)
        sw_done = torch.zeros((B,), dtype=torch.bool, device=dev)
        sw_done[sw_rows] = True
    else:
        best = sw_pass(oriented_sw, lens, lens_t, t_start_o, anchor5, anchor3, cand_idx[:, 0])
        if top_k == 2 and B >= 8:
            # margin-pruned second pass: candidate 2 only for the quarter of
            # the batch with the smallest cosine margin
            margin = cand_scores[:, 0] - cand_scores[:, 1]
            amb = sketch.top_k(-margin, B // 4)[1]
            cur = sw_pass(oriented_sw[amb], lens[amb], lens_t[amb], t_start_o[amb],
                          anchor5[amb], anchor3[amb], cand_idx[amb, 1])
            better = cur["score"] > best["score"][amb]
            for k in best:
                best[k][amb] = torch.where(better, cur[k], best[k][amb])
        else:
            for c in range(1, top_k):
                cur = sw_pass(oriented_sw, lens, lens_t, t_start_o, anchor5, anchor3,
                              cand_idx[:, c])
                better = cur["score"] > best["score"]
                best = {k: torch.where(better, cur[k], best[k]) for k in best}
        sw_done = torch.ones((B,), dtype=torch.bool, device=dev)

    umi_out = _umi_windows(codes, lens_t, t_start, umi_masks, umi_mask_lens, a5=a5, a3=a3)
    # synthesized rows carry NaN (no alignment columns exist for them)
    blast_id = torch.where(
        sw_done,
        best["n_match"].to(torch.float32) / best["n_cols"].clamp(min=1).to(torch.float32),
        _f32(float("nan"), dev),
    )
    return {
        "lens": lens_t, "t_start": t_start, "ee_ok": ee_ok, "is_rev": is_rev,
        "ridx": best["ridx"], "score": best["score"], "blast_id": blast_id,
        "ref_start": best["ref_start"], "ref_end": best["ref_end"],
        "read_start": best["read_start"], "read_end": best["read_end"],
        "sw_done": sw_done, **umi_out,
    }


def _targeted_pass(codes, lens, cand_idx, ref_codes, ref_lens, umi_masks,
                   umi_mask_lens, min_len: int, *, band_width: int, a5: int,
                   a3: int) -> dict:
    """Round-2 pass: align each consensus ONLY against its region cluster's
    references (``cand_idx`` (B, max_c) int32, -1 padded); no trim, no EE
    data, no strand search. Same out-dict contract as :func:`_fused_pass`."""
    B, W = codes.shape
    dev = codes.device
    lens_t = lens.to(torch.int32)
    t_start = torch.zeros((B,), dtype=torch.int32, device=dev)

    def sw_one(ridx):
        valid_c = ridx >= 0
        r = torch.where(valid_c, ridx, 0).long()
        rl = ref_lens[r]
        m5 = torch.div(lens_t - rl, 2, rounding_mode="floor")
        res = sw_kernel.align_banded_auto(
            codes, lens_t, ref_codes[r], rl, (-m5).to(torch.int32), band_width=band_width,
        )
        return {
            "ridx": r.to(torch.int32),
            "score": torch.where(valid_c, res.score, -1).to(torch.int32),
            "n_match": res.n_match, "n_cols": res.n_cols,
            "ref_start": res.ref_start, "ref_end": res.ref_end,
            "read_start": res.read_start, "read_end": res.read_end,
        }

    best = sw_one(cand_idx[:, 0])
    for c in range(1, cand_idx.shape[1]):
        cur = sw_one(cand_idx[:, c])
        better = cur["score"] > best["score"]  # ties keep the earlier ref
        best = {k: torch.where(better, cur[k], best[k]) for k in best}

    umi_out = _umi_windows(codes, lens_t, t_start, umi_masks, umi_mask_lens, a5=a5, a3=a3)
    blast_id = best["n_match"].to(torch.float32) / best["n_cols"].clamp(min=1).to(torch.float32)
    return {
        "lens": lens_t, "t_start": t_start, "ee_ok": lens_t >= min_len,
        "is_rev": torch.zeros((B,), dtype=torch.bool, device=dev),
        "ridx": best["ridx"], "score": best["score"], "blast_id": blast_id,
        "ref_start": best["ref_start"], "ref_end": best["ref_end"],
        "read_start": best["read_start"], "read_end": best["read_end"],
        "sw_done": torch.ones((B,), dtype=torch.bool, device=dev), **umi_out,
    }


# ---------------------------------------------------------------------------
# columnar survivors


@dataclasses.dataclass
class ReadBlock:
    """Columnar arrays for the survivors of one width bucket."""

    width: int
    codes: np.ndarray        # (n, W) uint8 (trimmed, original orientation)
    lens: np.ndarray         # (n,) int32
    names: list[str]
    is_rev: np.ndarray       # (n,) bool
    region_idx: np.ndarray   # (n,) int32
    blast_id: np.ndarray     # (n,) float32
    ref_start: np.ndarray    # (n,) int32 — aligned reference span (exclusive end)
    ref_end: np.ndarray
    umi: dict[str, np.ndarray]  # d5,s5,e5,d3,s3,e3,start3 — (n,) int32 each
    quals: np.ndarray | None = None  # (n, W) uint8 phred, trimmed like codes
    sw_done: np.ndarray | None = None  # (n,) bool — blast_id/spans from SW

    @property
    def num_reads(self) -> int:
        return len(self.lens)

    def decode(self, rows: np.ndarray) -> list[str]:
        return encode.decode_batch(self.codes[rows], self.lens[rows])

    def decode_one(self, row: int) -> str:
        return encode.decode_batch(self.codes[row : row + 1], self.lens[row : row + 1])[0]


@dataclasses.dataclass
class ReadStore:
    """All surviving reads of one library, as per-width columnar blocks."""

    blocks: list[ReadBlock]

    @property
    def num_reads(self) -> int:
        return sum(b.num_reads for b in self.blocks)

    def group_rows_by(self, key_of_region: np.ndarray) -> dict[int, list[tuple[int, np.ndarray]]]:
        """Group reads by ``key_of_region[region_idx]``:
        {key: [(block_index, row_indices), ...]}."""
        groups: dict[int, list[tuple[int, np.ndarray]]] = defaultdict(list)
        for bi, blk in enumerate(self.blocks):
            keys = key_of_region[blk.region_idx]
            for key in np.unique(keys):
                groups[int(key)].append((bi, np.where(keys == key)[0]))
        return dict(groups)


@dataclasses.dataclass
class LengthStats:
    """seqkit-stat-style aggregates (the reference's read-stats artifact)."""

    n: int = 0
    sum_len: int = 0
    min_len: int = 0
    max_len: int = 0
    sum_qual: float = 0.0   # mean-Phred sum over reads (0 when no quals)

    def update(self, lens: np.ndarray, mean_quals: np.ndarray | None = None):
        if lens.size == 0:
            return
        self.n += int(lens.size)
        self.sum_len += int(lens.sum())
        mn = int(lens.min())
        self.min_len = mn if self.min_len == 0 else min(self.min_len, mn)
        self.max_len = max(self.max_len, int(lens.max()))
        if mean_quals is not None and mean_quals.size:
            self.sum_qual += float(mean_quals.sum())

    @property
    def avg_len(self) -> float:
        return self.sum_len / self.n if self.n else 0.0

    @property
    def avg_qual(self) -> float:
        return self.sum_qual / self.n if self.n else 0.0


@dataclasses.dataclass
class AlignStats:
    n_total: int = 0
    n_ee_fail: int = 0
    n_trimmed: int = 0     # reads with at least one primer cut
    n_aligned: int = 0     # score >= MIN_SCORE among EE survivors
    n_unaligned: int = 0   # EE survivors below the score gate
    n_short: int = 0
    n_long: int = 0
    n_low_blast: int = 0
    n_pass: int = 0
    n_ingested: int = 0        # records drawn from the parser
    n_bucket_short: int = 0    # dropped below the batcher min_len gate
    n_bucket_long: int = 0     # dropped above the largest width bucket
    pre_filter: LengthStats = dataclasses.field(default_factory=LengthStats)
    post_filter: LengthStats = dataclasses.field(default_factory=LengthStats)


# ---------------------------------------------------------------------------
# host engine


class AssignEngine:
    """Device constants for the read passes of one run, on ``device`` (the
    card when None)."""

    def __init__(
        self,
        panel: ReferencePanel,
        umi_fwd: str,
        umi_rev: str,
        primers: list[str] | None = None,
        primer_max_dist_frac: float = 0.15,
        top_k: int = 2,
        band_width: int = 128,
        a5: int = 81,
        a3: int = 76,
        trim_window: int = 150,
        fast_denom: int = 4,
        device: str | torch.device | None = None,
    ):
        self.panel = panel
        self.top_k = top_k
        self.band_width = band_width
        self.a5 = a5
        self.a3 = a3
        self.trim_window = trim_window
        self.fast_denom = fast_denom
        self.device = resolve_device(device)

        def stack_masks(masks: list[np.ndarray]):
            stacked, lens_ = encode.pad_batch(masks, pad_value=0, multiple=1)
            return (torch.from_numpy(stacked).to(self.device),
                    torch.from_numpy(lens_).to(self.device))

        self.umi_masks, self.umi_mask_lens = stack_masks(
            [encode.encode_mask(umi_fwd), encode.encode_mask(umi_rev)]
        )
        primers = primers or []
        self.n_primers = len(primers)
        if primers:
            self.primer_stack, self.primer_stack_lens = stack_masks(
                [encode.encode_mask(p) for p in primers]
                + [encode.encode_mask(encode.revcomp_str(p)) for p in primers]
            )
        else:
            self.primer_stack = torch.zeros((0, 1), dtype=torch.uint8, device=self.device)
            self.primer_stack_lens = torch.zeros((0,), dtype=torch.int32, device=self.device)
        self.primer_max_dists = torch.tensor(
            [max(1, int(len(p) * primer_max_dist_frac)) for p in primers],
            dtype=torch.int32, device=self.device,
        )

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @staticmethod
    def _to_host(out: dict) -> dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in out.items()}

    def run_batch(self, batch: bucketing.ReadBatch, max_ee_rate: float, min_len: int,
                  overlap_frac: float | None = None) -> dict[str, np.ndarray]:
        """The fused pass on one batch; ``overlap_frac`` (round 1) arms the
        SW fast path."""
        fast = overlap_frac is not None and self.fast_denom > 0 and self.top_k == 2
        p = self.panel
        out = _fused_pass(
            self._upload(batch.codes),
            self._upload(batch.quals) if batch.quals is not None else None,
            self._upload(batch.lengths),
            p.d_codes, p.d_lens, p.d_profiles,
            self.umi_masks, self.umi_mask_lens,
            self.primer_stack, self.primer_stack_lens, self.primer_max_dists,
            max_ee_rate, min_len, overlap_frac if overlap_frac is not None else 0.0,
            top_k=self.top_k, band_width=self.band_width, a5=self.a5, a3=self.a3,
            trim_window=self.trim_window, n_primers=self.n_primers,
            sw_subset_denom=self.fast_denom if fast else 0,
        )
        return self._to_host(out)

    def run_batch_targeted(self, batch: bucketing.ReadBatch, cand_idx: np.ndarray,
                           min_len: int) -> dict[str, np.ndarray]:
        """Round-2 pass on one batch against its candidate refs."""
        p = self.panel
        out = _targeted_pass(
            self._upload(batch.codes), self._upload(batch.lengths), self._upload(cand_idx),
            p.d_codes, p.d_lens, self.umi_masks, self.umi_mask_lens, min_len,
            band_width=self.band_width, a5=self.a5, a3=self.a3,
        )
        return self._to_host(out)


def run_assign(
    source,
    engine: AssignEngine,
    max_ee_rate: float,
    min_len: int,
    minimal_region_overlap: float,
    max_softclip_5_end: int,
    max_softclip_3_end: int,
    batch_size: int = 1024,
    max_read_length: int = 4096,
    blast_id_threshold: float | None = None,
    collect_qc: list | None = None,
    subsample: int | None = None,
    dispatch=None,
) -> tuple[ReadStore, AlignStats]:
    """Stream a fastx file or record iterable through the fused pass.

    Filters mirror the reference's region split (ref-overlap + read-length
    window) plus — when ``blast_id_threshold`` is set (round 2) — the
    consensus blast-id gate. ``collect_qc``, when given, receives one row
    per aligned read (name, region, spans, blast id, filter status) for
    the consensus-filter QC artifacts. ``dispatch(batch, max_ee_rate,
    min_len)`` overrides the per-batch device call (round 2's targeted
    pass); every filter step is shared. Batches run one after another on
    this thread, in the JAX package's batch order, so the store's row order
    is the same. The ingest, partition and store conservation contracts are
    checked at the end.
    """
    panel = engine.panel
    stats = AlignStats()
    counters = bucketing.IngestCounters()
    acc: dict[int, list[dict]] = defaultdict(list)
    acc_names: dict[int, list[list[str]]] = defaultdict(list)
    widths = tuple(w for w in bucketing.DEFAULT_WIDTHS if w <= max_read_length)

    def consume(batch, out):
        valid = batch.valid
        nv = int(valid.sum())
        stats.n_total += nv
        lens = out["lens"]
        ee_ok = out["ee_ok"] & valid
        stats.n_ee_fail += int(nv - (ee_ok & valid).sum())
        stats.n_trimmed += int(((out["t_start"] > 0) & valid).sum())
        mean_quals = None
        if batch.quals is not None:
            pos = np.arange(batch.quals.shape[1])[None, :]
            in_span = (pos >= out["t_start"][:, None]) & (
                pos < (out["t_start"] + lens)[:, None]
            )
            qsum = np.where(in_span, batch.quals, 0).sum(axis=1)
            mean_quals = qsum / np.maximum(lens, 1)
        stats.pre_filter.update(
            lens[valid], mean_quals[valid] if mean_quals is not None else None
        )
        aligned = ee_ok & (out["score"] >= MIN_SCORE)
        stats.n_aligned += int(aligned.sum())
        stats.n_unaligned += int((ee_ok & ~aligned).sum())

        rlens = panel.lens[out["ridx"]]
        ref_span = out["ref_end"] - out["ref_start"]
        min_span = rlens * minimal_region_overlap
        max_len = rlens * (2 - minimal_region_overlap) + (
            max_softclip_5_end + max_softclip_3_end
        )
        short = aligned & (ref_span < min_span)
        long_ = aligned & ~short & (lens > max_len)
        stats.n_short += int(short.sum())
        stats.n_long += int(long_.sum())
        ok = aligned & ~short & ~long_
        if blast_id_threshold is not None:
            low = ok & ~(out["blast_id"] > blast_id_threshold)
            stats.n_low_blast += int(low.sum())
            ok = ok & ~low
        stats.n_pass += int(ok.sum())
        stats.post_filter.update(
            lens[ok], mean_quals[ok] if mean_quals is not None else None
        )

        if collect_qc is not None:
            status = np.full(len(valid), "", dtype=object)
            status[short] = "short"
            status[long_] = "long"
            if blast_id_threshold is not None:
                status[low] = "low_blast_id"
            status[ok] = "pass"
            for i in np.where(aligned)[0]:
                qc = {
                    "name": batch.ids[i].partition(" ")[0],
                    "region": panel.names[int(out["ridx"][i])],
                    "ref_span": int(ref_span[i]),
                    "read_len": int(lens[i]),
                    "region_len": int(rlens[i]),
                    "blast_id": float(out["blast_id"][i]),
                    "status": str(status[i]),
                }
                if status[i] == "short":
                    qc["nt_short"] = float(min_span[i] - ref_span[i])
                elif status[i] == "long":
                    qc["nt_long"] = float(lens[i] - max_len[i])
                collect_qc.append(qc)

        rows = np.where(ok)[0]
        if len(rows) == 0:
            return
        # trimmed survivor codes, rebuilt host-side from the unshifted batch
        Wb = batch.codes.shape[1]
        shift_idx = np.clip(out["t_start"][rows][:, None] + np.arange(Wb)[None, :], 0, Wb - 1)
        shifted = np.take_along_axis(batch.codes[rows], shift_idx, axis=1)
        in_new = np.arange(Wb)[None, :] < lens[rows][:, None]
        trimmed_codes = np.where(in_new, shifted, encode.PAD_CODE).astype(np.uint8)
        trimmed_quals = None
        if batch.quals is not None:
            q_shift = np.take_along_axis(batch.quals[rows], shift_idx, axis=1)
            trimmed_quals = np.where(in_new, q_shift, 0).astype(np.uint8)
        acc[batch.width].append({
            "codes": trimmed_codes,
            "quals": trimmed_quals,
            "lens": lens[rows],
            "is_rev": out["is_rev"][rows],
            "region_idx": out["ridx"][rows].astype(np.int32),
            "blast_id": out["blast_id"][rows].astype(np.float32),
            "ref_start": out["ref_start"][rows].astype(np.int32),
            "ref_end": out["ref_end"][rows].astype(np.int32),
            "sw_done": out["sw_done"][rows].astype(bool),
            **{k: out[k][rows].astype(np.int32) for k in _UMI_KEYS},
        })
        acc_names[batch.width].append([batch.ids[i].partition(" ")[0] for i in rows])

    source_desc = "<records>"
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        source_desc = source
        source = fastx.read_fastx(source)
    records = iter(source)

    def limited():
        taken = 0
        for rec in records:
            if subsample is not None and taken >= subsample:
                return
            taken += 1
            yield rec

    for batch in bucketing.batch_reads(limited(), batch_size=batch_size, widths=widths,
                                       min_len=1, counters=counters):
        if dispatch is not None:
            out = dispatch(batch, max_ee_rate, min_len)
        else:
            # overlap_frac arms the SW fast path only when no blast-id gate
            # runs (round 1): round 2's gate needs true blast-ids
            out = engine.run_batch(
                batch, max_ee_rate, min_len,
                overlap_frac=minimal_region_overlap if blast_id_threshold is None else None,
            )
        consume(batch, out)

    blocks = []
    for width in sorted(acc):
        parts = acc[width]
        blocks.append(ReadBlock(
            width=width,
            codes=np.concatenate([p["codes"] for p in parts]),
            lens=np.concatenate([p["lens"] for p in parts]),
            names=[n for ns in acc_names[width] for n in ns],
            is_rev=np.concatenate([p["is_rev"] for p in parts]),
            region_idx=np.concatenate([p["region_idx"] for p in parts]),
            blast_id=np.concatenate([p["blast_id"] for p in parts]),
            ref_start=np.concatenate([p["ref_start"] for p in parts]),
            ref_end=np.concatenate([p["ref_end"] for p in parts]),
            umi={k: np.concatenate([p[k] for p in parts]) for k in _UMI_KEYS},
            quals=(np.concatenate([p["quals"] for p in parts])
                   if all(p["quals"] is not None for p in parts) else None),
            sw_done=np.concatenate([p["sw_done"] for p in parts]),
        ))
    stats.n_ingested = counters.n_records
    stats.n_bucket_short = counters.n_dropped_short
    stats.n_bucket_long = counters.n_dropped_long
    store = ReadStore(blocks=blocks)
    # conservation: the parsed records minus the bucket drops are what the
    # device pass counted, the filter categories partition that total, and
    # the store holds exactly the passing reads
    src_desc = str(source_desc)[:200]
    contracts.check_equal(
        "ingest", "records parsed minus bucket drops",
        counters.n_records - counters.n_dropped_short - counters.n_dropped_long,
        "reads entering the device pass", stats.n_total,
        detail={"source": src_desc, "ingested": counters.n_records,
                "bucket_short": counters.n_dropped_short,
                "bucket_long": counters.n_dropped_long},
    )
    contracts.check_equal(
        "assign_partition", "filter category sum",
        stats.n_ee_fail + stats.n_unaligned + stats.n_short + stats.n_long
        + stats.n_low_blast + stats.n_pass,
        "batch total", stats.n_total, detail={"source": src_desc},
    )
    contracts.check_equal(
        "assign_store", "columnar store rows", store.num_reads,
        "passing reads", stats.n_pass, detail={"source": src_desc},
    )
    return store, stats
