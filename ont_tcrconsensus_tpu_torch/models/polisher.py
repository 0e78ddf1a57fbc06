"""Bidirectional-GRU consensus polisher (``polish_method: "rnn"``).

The counterpart of the JAX package's ``models/polisher.py`` serving path:
per draft position of a cluster, pileup features (``ops/consensus``) ->
Dense(96) -> GELU -> two bidirectional GRU layers of hidden 96 -> Dense(10).
The first five logits are the class head (A/C/G/T, or 4 = the draft
position is absent from the true sequence), the last five the insertion
head (0 = nothing inserted after the position, 1-4 = the base the draft
missed there). Positions where the softmax clears ``min_confidence`` are
rewritten, and the deletions and insertions spliced on the host.

The JAX package computes this network with XLA (Flax ``nn.RNN`` scans),
not with a Pallas kernel, so here it is ``torch.nn.GRU`` and
``torch.nn.Linear`` on either device (cuDNN on the card), in float32 with
TF32 off. The weights are the JAX package's Flax msgpack files, bundled
under ``weights/`` and read with ``msgpack`` alone (:func:`load_params`);
``convert.polisher_from_numpy`` maps them onto the torch modules.
"""

from __future__ import annotations

import os

import msgpack
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ont_tcrconsensus_tpu_torch.device import resolve_device
from ont_tcrconsensus_tpu_torch.obs import device as obs_device
from ont_tcrconsensus_tpu_torch.ops import consensus as consensus_mod
from ont_tcrconsensus_tpu_torch.ops import pileup as pileup_mod
from ont_tcrconsensus_tpu_torch.ops.encode import PAD_CODE

NUM_CLASSES = 5
NUM_INS_CLASSES = 5   # none / +A / +C / +G / +T
TOTAL_LOGITS = NUM_CLASSES + NUM_INS_CLASSES
FEATURE_DIM = 15      # ops.consensus.pileup_features (v1-v3 weights)


class ConsensusPolisher(nn.Module):
    """Dense -> GELU -> 2x bi-GRU -> class + insertion heads.

    Each GRU runs over the full padded width, padding included, as Flax's
    ``nn.RNN(reverse=True, keep_order=True)`` does for the backward
    direction.
    """

    def __init__(self, feature_dim: int = FEATURE_DIM, hidden: int = 96, num_layers: int = 2):
        super().__init__()
        self.embed = nn.Linear(feature_dim, hidden)
        self.grus = nn.ModuleList(
            nn.GRU(hidden if i == 0 else 2 * hidden, hidden, batch_first=True,
                   bidirectional=True)
            for i in range(num_layers)
        )
        self.head = nn.Linear(2 * hidden, TOTAL_LOGITS)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, L, F) -> (B, L, 10) logits."""
        x = F.gelu(self.embed(feats), approximate="tanh")  # flax.linen.gelu's default
        for gru in self.grus:
            x, _ = gru(x)
        return self.head(x)


def _ext_hook(code: int, data: bytes):
    """Flax's msgpack extension: type 1 is an ndarray stored as msgpack
    ``(shape, dtype name, raw bytes)``."""
    if code != 1:
        raise ValueError(f"unsupported msgpack extension type {code} in a weights file")
    shape, dtype, raw = msgpack.unpackb(data, raw=True)
    return np.frombuffer(raw, dtype=np.dtype(dtype.decode())).reshape(shape)


def load_params(path: str) -> dict:
    """A Flax params tree (nested dicts of numpy arrays) from its msgpack
    file, without Flax."""
    with open(path, "rb") as fh:
        return msgpack.unpackb(fh.read(), ext_hook=_ext_hook, raw=False)


def params_feature_dim(params: dict) -> int:
    """The feature width a params tree was trained for (the embed kernel's
    fan-in): 15 serves :func:`pileup_features`, 25 the v4 features."""
    return int(np.asarray(params["embed"]["kernel"]).shape[0])


_WEIGHTS_DIR = os.path.join(os.path.dirname(__file__), "weights")
DEFAULT_WEIGHTS = os.path.join(_WEIGHTS_DIR, "polisher_v2.msgpack")
# newest generation first; v4 lost the main slot on held-out exactness and
# serves only the depth-2 pass (LOW_DEPTH_WEIGHTS)
_WEIGHT_PREFERENCE = (os.path.join(_WEIGHTS_DIR, "polisher_v3.msgpack"), DEFAULT_WEIGHTS)
LOW_DEPTH_WEIGHTS = os.path.join(_WEIGHTS_DIR, "polisher_v4.msgpack")
LOW_DEPTH_EVIDENCE = os.path.join(_WEIGHTS_DIR, "polisher_depth_gate_blastid.json")


def serving_weights_path() -> str:
    """The weights file the pipeline serves: the newest generation whose
    held-out evaluation (``<name>_eval.json``) sits beside it; v2 predates
    the evaluations and is the ungated floor."""
    for path in _WEIGHT_PREFERENCE:
        if not os.path.exists(path):
            continue
        if path != DEFAULT_WEIGHTS and not os.path.exists(os.path.splitext(path)[0] + "_eval.json"):
            continue
        return path
    return DEFAULT_WEIGHTS


def load_default_params() -> dict | None:
    """The served weights tree, or None when no weights are bundled."""
    path = serving_weights_path()
    return load_params(path) if os.path.exists(path) else None


def load_low_depth_params() -> dict | None:
    """Weights of the exactly-depth-2 pass (v4), served only beside their
    evidence file; else None."""
    if os.path.exists(LOW_DEPTH_WEIGHTS) and os.path.exists(LOW_DEPTH_EVIDENCE):
        return load_params(LOW_DEPTH_WEIGHTS)
    return None


def _predictions(model: ConsensusPolisher, feats: torch.Tensor, base_at: torch.Tensor):
    """Per position: class argmax and its softmax probability, insertion
    argmax and its probability, and the pileup depth; numpy, read back
    under ``polisher.get`` (its wait credited to the enclosing
    ``polish.dispatch``)."""
    logits = model(feats)
    cls, ins = logits[..., :NUM_CLASSES], logits[..., NUM_CLASSES:]
    out = (
        torch.argmax(cls, dim=-1).to(torch.uint8),
        torch.softmax(cls, dim=-1).amax(dim=-1),
        (base_at != pileup_mod.UNCOVERED).sum(dim=1),
        torch.argmax(ins, dim=-1).to(torch.uint8),
        torch.softmax(ins, dim=-1).amax(dim=-1),
    )
    return obs_device.timed_get("polisher.get", out)


def make_pipeline_polisher(params, band_width: int | None = None,
                           min_confidence: float = 0.9,
                           min_polish_depth: int = 4,
                           iterations: int = 1,
                           low_depth_params=None,
                           low_depth: int = 2,
                           device: str | torch.device | None = None):
    """The polisher that ``stages.polish_clusters_all(polisher=...)`` calls
    once per (C, S, W) cluster tile, its network on ``device`` (the card
    when None).

    Returns f(sub (C,S,W), lens (C,S), drafts (C,W), dlens (C,),
    pileup=None, band_width=None, quals=None, strands=None, mesh=None) ->
    (polished (C,W), polished_lens (C,)), numpy. ``pileup`` is the consensus rounds'
    kept final pileup (``consensus_clusters_batch(keep_final_pileup=True)``);
    when None it is recomputed against the drafts at ``band_width`` (the
    stage's band, so reused and recomputed pileups share one scale);
    ``mesh`` splits that recomputed pileup over its data slices, and the
    network then runs on the gathered columns on ``device`` (the first
    slice's).

    ``min_polish_depth``: clusters with fewer live subreads keep their vote
    consensus. ``low_depth_params``: weights for clusters of exactly
    ``low_depth`` live subreads, which get this model's predictions
    instead; both models share one pileup. ``iterations`` > 1 re-piles
    against the polished draft and applies the model again. With v4
    weights, ``quals`` (C,S,W) phred and ``strands`` (C,S) is-reverse feed
    the strand and quality channels; without quals every base reads
    ``QUAL_FILL``. The host splice keeps confident substitutions, drops
    confident deletions and inserts confident missed bases, in a fixed
    width W.
    """
    from ont_tcrconsensus_tpu_torch import convert

    device = resolve_device(device)
    default_band = consensus_mod.POLISH_BAND_WIDTH if band_width is None else band_width
    wants_v4 = params_feature_dim(params) == consensus_mod.FEATURE_DIM_V4
    low_v4 = (low_depth_params is not None
              and params_feature_dim(low_depth_params) == consensus_mod.FEATURE_DIM_V4)
    need_v4 = wants_v4 or low_v4
    model = convert.polisher_from_numpy(params, device=device)
    low_model = (convert.polisher_from_numpy(low_depth_params, device=device)
                 if low_depth_params is not None else None)

    def serve(net, v4, pileup, drafts_t, quals_t, strands_t):
        base_at, ins_cnt, ins_base, pos_at = pileup
        if v4:
            feats = consensus_mod.pileup_features_v4(
                base_at, ins_cnt, ins_base, drafts_t, pos_at, quals_t, strands_t)
        else:
            feats = consensus_mod.pileup_features(base_at, ins_cnt, ins_base, drafts_t)
        return _predictions(net, feats, base_at)

    @torch.inference_mode()
    def polish_once(sub, lens, drafts, dlens, pileup, band_width, quals, strands, mesh):
        drafts = np.asarray(drafts)
        dlens = np.asarray(dlens)
        live = (np.asarray(lens) > 0).sum(axis=1)
        low_mask = (live == low_depth) if low_model is not None else np.zeros(live.shape, bool)
        use_low = bool(low_mask.any())
        quals_t = strands_t = None
        if need_v4:
            if quals is None:
                quals = np.full(np.asarray(sub).shape, consensus_mod.QUAL_FILL, np.uint8)
            if strands is None:
                strands = np.zeros(np.asarray(lens).shape, bool)
            quals_t = torch.from_numpy(np.ascontiguousarray(quals)).to(device)
            strands_t = torch.from_numpy(np.ascontiguousarray(strands)).to(device)
            if pileup is not None and pileup[3] is None:
                pileup = None  # kept without pos_at, which the v4 features read
        drafts_t = torch.from_numpy(np.ascontiguousarray(drafts)).to(device)
        if pileup is None:
            base_at, ins_cnt, ins_base, pos_at, _ = pileup_mod.pileup_columns_batch_auto(
                torch.from_numpy(np.ascontiguousarray(sub)).to(device),
                torch.from_numpy(np.ascontiguousarray(lens)).to(device),
                drafts_t, torch.from_numpy(np.ascontiguousarray(dlens)).to(device),
                band_width=default_band if band_width is None else band_width,
                out_len=drafts.shape[1], mesh=mesh,
            )
            pileup = (base_at, ins_cnt, ins_base, pos_at)
        pred, conf, depth, ins_pred, ins_conf = serve(
            model, wants_v4, pileup, drafts_t, quals_t, strands_t)
        if use_low:
            # the depth-2 pass's predictions replace the main model's only
            # on the clusters of exactly low_depth live subreads
            pred_l, conf_l, _, ins_pred_l, ins_conf_l = serve(
                low_model, low_v4, pileup, drafts_t, quals_t, strands_t)
            m = low_mask[:, None]
            pred = np.where(m, pred_l, pred)
            conf = np.where(m, conf_l, conf)
            ins_pred = np.where(m, ins_pred_l, ins_pred)
            ins_conf = np.where(m, ins_conf_l, ins_conf)
        return _splice(drafts, dlens, live, low_mask, pred, conf, depth, ins_pred, ins_conf,
                       min_confidence, min_polish_depth)

    def polish(sub, lens, drafts, dlens, pileup=None, band_width=None, quals=None,
               strands=None, mesh=None):
        for _ in range(max(int(iterations), 1)):
            drafts, dlens = polish_once(sub, lens, drafts, dlens, pileup, band_width,
                                        quals, strands, mesh)
            pileup = None  # later passes re-pile against the new draft
        return drafts, dlens

    # the polish stage keeps the pos_at plane for the v4 features when set
    polish.wants_v4 = need_v4
    return polish


def _splice(drafts, dlens, live, low_mask, pred, conf, depth, ins_pred, ins_conf,
            min_confidence, min_polish_depth):
    """Apply the gated predictions on the host: slot 2j holds draft
    position j (rewritten, or dropped as a deletion), slot 2j+1 an inserted
    base; kept slots are compacted into width W (a cluster that would
    overflow keeps its tail un-inserted)."""
    C, W = drafts.shape
    pos = np.arange(W)
    out = np.full_like(drafts, PAD_CODE)
    out_lens = np.zeros_like(dlens)
    in_draft = pos[None, :] < dlens[:, None]
    deep_enough = (live >= min_polish_depth)[:, None] | low_mask[:, None]
    covered = in_draft & (depth > 0) & deep_enough
    apply = covered & (conf >= min_confidence)
    base = np.where(apply, pred, drafts)
    keep = in_draft & ~(apply & (pred == 4))
    do_ins = covered & (ins_conf >= min_confidence) & (ins_pred > 0)
    slot_base = np.stack([base, np.where(do_ins, ins_pred - 1, 0)], axis=2).reshape(C, 2 * W)
    slot_keep = np.stack([keep, do_ins], axis=2).reshape(C, 2 * W)
    for c in range(C):
        if dlens[c] == 0:
            continue
        kept = slot_base[c][slot_keep[c]].astype(np.uint8)[:W]
        out[c, : kept.size] = kept
        out_lens[c] = kept.size
    return out, out_lens
