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
TF32 off, or in bfloat16 behind the exactness A/B gate
(:func:`bf16_serving_certified`). The weights are the JAX package's Flax
msgpack files, bundled under ``weights/``, read and written with
``msgpack`` alone (:func:`load_params`, :func:`save_params`);
``convert.polisher_from_numpy`` and ``convert.polisher_to_numpy`` map
them onto the torch modules and back.

Training (``models/train.py``) runs the same module through autograd:
:func:`cross_entropy_loss` and one ``torch.optim.Adam`` step a batch
(:func:`make_train_step`). Flax's ``GRUCell`` has no hidden-side bias for
its r and z gates, where torch's GRU has one; the module zeroes those
biases' gradient, so they stay exactly zero and the trained weights keep
Flax's form.
"""

from __future__ import annotations

import json
import os
import time

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


def _zero_rz_rows(grad: torch.Tensor) -> torch.Tensor:
    """A bias_hh gradient with its r and z rows (the first two thirds)
    zeroed."""
    grad = grad.clone()
    grad[: 2 * grad.shape[0] // 3] = 0
    return grad


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
        # torch's bias_hh is (r, z, n); Flax has only the n part (``hn``),
        # and b_ir + b_hr only ever appear summed, so a learned b_hr would
        # double the r gate's bias step: its r and z rows get no gradient
        for gru in self.grus:
            for name, p in gru.named_parameters():
                if name.startswith("bias_hh"):
                    p.register_hook(_zero_rz_rows)

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


def init_params(rng_seed: int = 0, length: int = 128, feature_dim: int = FEATURE_DIM,
                hidden: int = 96, num_layers: int = 2) -> dict:
    """A fresh params tree in Flax's layout (numpy float32), drawn with
    Flax's initializers from a ``torch.Generator`` seeded ``rng_seed``:
    Dense and input-side GRU kernels lecun-normal (a normal truncated at
    two standard deviations, scaled to variance 1/fan_in), the GRU's
    recurrent kernels orthogonal, every bias zero. The structure and
    shapes are the JAX package's; the values are not (the generators
    differ). ``length`` is unused (the JAX function's dummy input length)."""
    from ont_tcrconsensus_tpu_torch import convert

    gen = torch.Generator().manual_seed(int(rng_seed))

    def lecun(fan_in: int, fan_out: int) -> np.ndarray:
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # truncation's variance
        w = torch.empty(fan_in, fan_out)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        return w.numpy()

    def orthogonal(n: int) -> np.ndarray:
        w = torch.empty(n, n)
        nn.init.orthogonal_(w, generator=gen)
        return w.numpy()

    def zeros(n: int) -> np.ndarray:
        return np.zeros((n,), np.float32)

    tree = {"embed": {"kernel": lecun(feature_dim, hidden), "bias": zeros(hidden)}}
    fan_in = hidden
    for i in range(num_layers):
        layer = {}
        for cell in ("GRUCell_0", "GRUCell_1"):
            gates = {g: {"kernel": lecun(fan_in, hidden), "bias": zeros(hidden)}
                     for g in ("ir", "iz", "in")}
            gates["hr"] = {"kernel": orthogonal(hidden)}
            gates["hz"] = {"kernel": orthogonal(hidden)}
            gates["hn"] = {"kernel": orthogonal(hidden), "bias": zeros(hidden)}
            layer[cell] = gates
        tree[f"bigru{i}"] = layer
        fan_in = 2 * hidden
    tree["head"] = {"kernel": lecun(2 * hidden, TOTAL_LOGITS), "bias": zeros(TOTAL_LOGITS)}
    return convert._sorted_tree(tree)


def _bf16_copy(model: ConsensusPolisher) -> ConsensusPolisher:
    """A separate bfloat16 module with ``model``'s weights (``model`` itself
    is never cast)."""
    twin = ConsensusPolisher(model.embed.in_features, model.embed.out_features,
                             len(model.grus))
    twin.load_state_dict(model.state_dict())
    return twin.to(device=model.embed.weight.device, dtype=torch.bfloat16).eval()


def apply_logits(params, feats, bf16: bool = False,
                 device: str | torch.device | None = None) -> torch.Tensor:
    """(B, L, F) features -> (B, L, 10) float32 logits: [:5] the class
    head, [5:] the insertion head.

    ``params`` is a Flax params tree (the network is built on ``device``,
    the card when None) or a :class:`ConsensusPolisher` (run where it
    lives, with autograd if grad mode is on). ``bf16`` runs the whole
    network, parameters and activations, in bfloat16 on a separate copy
    of the weights and casts the logits back to float32 (the JAX
    package's ``_cast_bf16``); serving uses it only behind
    :func:`bf16_serving_certified`.
    """
    from ont_tcrconsensus_tpu_torch import convert

    dtype = torch.bfloat16 if bf16 else torch.float32
    if isinstance(params, ConsensusPolisher):
        model = _bf16_copy(params) if bf16 else params
    else:
        model = convert.polisher_from_numpy(params, device=device, dtype=dtype)
    x = torch.as_tensor(feats).to(device=model.embed.weight.device, dtype=dtype)
    return model(x).to(torch.float32)


def polish_draft(params, feats, draft: np.ndarray, draft_len: int,
                 depth: np.ndarray | None = None, min_confidence: float = 0.9,
                 device: str | torch.device | None = None) -> tuple[np.ndarray, int]:
    """The polisher applied to one draft (network on ``device``, the card
    when None): confident substitutions applied, confident deletions cut,
    confident insertions spliced in.

    Args: feats (L, F) pileup features; draft (L,) codes; draft_len its
    length; depth (L,) pileup depth (positions without coverage keep the
    draft base); the model overrides the draft only where its softmax
    probability reaches ``min_confidence``. Returns (polished codes padded
    to 2*L, new length).
    """
    with torch.inference_mode():
        logits = apply_logits(params, torch.as_tensor(np.asarray(feats))[None],
                              device=device)[0].cpu().numpy()
    cls, ins = logits[:, :NUM_CLASSES], logits[:, NUM_CLASSES:]

    def softmax_conf(lg):
        p = np.exp(lg - lg.max(axis=-1, keepdims=True))
        p /= p.sum(axis=-1, keepdims=True)
        return lg.argmax(axis=-1).astype(np.uint8), p.max(axis=-1)

    pred, conf = softmax_conf(cls)
    ins_pred, ins_conf = softmax_conf(ins)
    L = draft.shape[0]
    in_draft = np.arange(L) < int(draft_len)
    covered = in_draft if depth is None else (in_draft & (np.asarray(depth) > 0))
    apply = covered & (conf >= min_confidence)
    base = np.where(apply, pred, draft)
    keep = in_draft & ~(apply & (pred == 4))
    do_ins = covered & (ins_conf >= min_confidence) & (ins_pred > 0)
    slot_base = np.stack([base, np.where(do_ins, ins_pred - 1, 0)], axis=1).reshape(-1)
    slot_keep = np.stack([keep, do_ins], axis=1).reshape(-1)
    kept = slot_base[slot_keep].astype(np.uint8)
    out = np.full((2 * L,), PAD_CODE, np.uint8)
    out[: kept.size] = kept
    return out, int(kept.size)


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
    logits = model(feats.to(model.embed.weight.dtype)).to(torch.float32)
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
                           bf16: bool = False,
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

    ``bf16``: every network dispatch (the main model's and the depth-2
    pass's) runs in bfloat16 on bf16 copies of the weights, logits cast
    back to float32. Callers gate it on :func:`bf16_serving_certified`
    (``pipeline/run.py`` does; ``scripts/torch_bf16_ab.py`` writes the
    certificate).
    """
    from ont_tcrconsensus_tpu_torch import convert

    device = resolve_device(device)
    default_band = consensus_mod.POLISH_BAND_WIDTH if band_width is None else band_width
    wants_v4 = params_feature_dim(params) == consensus_mod.FEATURE_DIM_V4
    low_v4 = (low_depth_params is not None
              and params_feature_dim(low_depth_params) == consensus_mod.FEATURE_DIM_V4)
    need_v4 = wants_v4 or low_v4
    dtype = torch.bfloat16 if bf16 else torch.float32
    model = convert.polisher_from_numpy(params, device=device, dtype=dtype)
    low_model = (convert.polisher_from_numpy(low_depth_params, device=device, dtype=dtype)
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


# ---------------------------------------------------------------------------
# training (models/train.py drives it)


def cross_entropy_loss(model: ConsensusPolisher, feats, labels, ins_labels, mask) -> torch.Tensor:
    """The two-head loss, class (base or deletion) plus insertion, each
    the mask-weighted mean negative log-likelihood: ``mask`` holds loss
    weights (0 unsupervised, 1, or up to ``err_weight`` where the draft is
    wrong), each head normalized by ``max(mask.sum(), 1)``."""
    logits = apply_logits(model, feats)
    cls, ins = logits[..., :NUM_CLASSES], logits[..., NUM_CLASSES:]

    def ce(lg, lab):
        ll = torch.log_softmax(lg, dim=-1).gather(-1, lab[..., None].long())[..., 0]
        return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    return ce(cls, labels) + ce(ins, ins_labels)


def trainable(params, device: str | torch.device | None = None) -> ConsensusPolisher:
    """A polisher built from a Flax params tree on ``device`` (the card
    when None) in training mode, which cuDNN's RNN backward needs; build
    the optimizer on this module's parameters."""
    from ont_tcrconsensus_tpu_torch import convert

    model = convert.polisher_from_numpy(params, device=device).train()
    for gru in model.grus:
        gru.flatten_parameters()
    return model


def make_train_step(optimizer: torch.optim.Optimizer):
    """f(model, feats, labels, ins_labels, mask) -> loss: one step of
    ``optimizer`` (``torch.optim.Adam``, the JAX package's ``optax.adam``)
    on the gradient of :func:`cross_entropy_loss` through autograd; the
    model and the optimizer's state are updated in place and the loss
    before the step is returned (a 0-d tensor)."""

    def train_step(model, feats, labels, ins_labels, mask):
        optimizer.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(model, feats, labels, ins_labels, mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def _ext_pack(obj):
    """Flax's msgpack extension for an ndarray: type 1, msgpack
    ``(shape, dtype name, raw C-order bytes)``."""
    if isinstance(obj, np.ndarray):
        return msgpack.ExtType(1, msgpack.packb((obj.shape, obj.dtype.name, obj.tobytes("C")),
                                                use_bin_type=True))
    raise TypeError(f"cannot write {type(obj).__name__} into a weights file")


def save_params(params: dict, path: str) -> None:
    """Write a params tree (Flax's layout, array leaves) to ``path`` as
    Flax's ``to_bytes`` does: msgpack, keys sorted at every level, each
    array an extension of type 1. The JAX package's ``load_params`` reads
    it."""
    def host(tree):
        return {k: host(v) if isinstance(v, dict) else np.asarray(v)
                for k, v in sorted(tree.items())}

    with open(path, "wb") as fh:
        fh.write(msgpack.packb(host(params), default=_ext_pack, strict_types=True))


# ---------------------------------------------------------------------------
# the bf16 serving gate: bf16 is served only where an exactness A/B on the
# same kind of device showed byte-identical consensus output


def bf16_ab_artifact_path(backend: str) -> str:
    return os.path.join(_WEIGHTS_DIR, f"polisher_bf16_ab_{backend}.json")


def _current_low_depth_basename() -> str | None:
    """Basename of the depth-2 pass's weights that would serve now, or
    None: the A/B records it and the gate checks it, so a specialist that
    appears or changes after the A/B voids the certificate."""
    if os.path.exists(LOW_DEPTH_WEIGHTS) and os.path.exists(LOW_DEPTH_EVIDENCE):
        return os.path.basename(LOW_DEPTH_WEIGHTS)
    return None


def _backend_of(device: str | torch.device | None) -> tuple[str, str]:
    """(backend, device kind) of ``device``: ``("gpu", the card's name)``
    for a card (the first card's when None and one is there), else
    ``("cpu", "cpu")``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return "gpu", torch.cuda.get_device_name(dev)
    return dev.type, dev.type


def bf16_serving_certified(backend: str | None = None, device_kind: str | None = None,
                           min_polish_depth: int = 4,
                           device: str | torch.device | None = None) -> bool:
    """True when bf16 serving is allowed: the backend's A/B artifact
    (:func:`run_bf16_exactness_ab`) exists, says ``identical: true``, and
    was made with (a) the weights served now, (b) the depth-2 pass served
    now (or its absence), (c) the same kind of device (``device_kind``;
    not checked when None) and (d) the same ``min_polish_depth``. A
    retrain, another specialist, another card or another depth gate each
    need a new A/B. ``backend`` and ``device_kind`` default to those of
    ``device`` (the run's device; the card when None and one is there):
    ``"gpu"`` and ``torch.cuda.get_device_name()``. The CPU is never
    certified: bf16 has nothing to win there.
    """
    if backend is None:
        backend, kind = _backend_of(device)
        if device_kind is None:
            device_kind = kind
    if backend == "cpu":
        return False
    path = bf16_ab_artifact_path(backend)
    if not os.path.exists(path):
        return False
    try:
        with open(path) as fh:
            rec = json.load(fh)
    except (OSError, ValueError):
        return False
    return (
        bool(rec.get("identical"))
        and rec.get("weights") == os.path.basename(serving_weights_path())
        and rec.get("low_depth_weights") == _current_low_depth_basename()
        and rec.get("min_polish_depth") == min_polish_depth
        and (device_kind is None or rec.get("device_kind") == device_kind)
    )


def run_bf16_exactness_ab(n_clusters: int = 96, depths: tuple[int, ...] = (2, 4, 6, 10),
                          template_len: int = 1300, seed: int = 17,
                          out_path: str | None = None, write: bool = True,
                          min_polish_depth: int = 4,
                          device: str | torch.device | None = None) -> dict:
    """Exactness A/B of the pipeline polisher, float32 against bfloat16, on
    ``device`` (the card when None).

    ``n_clusters`` simulated clusters cycling over ``depths`` (the
    systematic ONT error model, oriented reads with qualities, the JAX
    package's draws from ``seed``) go through the vote consensus once,
    then through the full pipeline polisher (the depth-2 pass included
    when it is served) once in float32 and once in bfloat16; the polished
    codes and lengths are compared byte for byte. Both arms share the
    drafts and the pileup, so a difference is exactly a decision bf16
    flipped. Returns the record and, with ``write``, writes it to
    ``out_path`` (default :func:`bf16_ab_artifact_path` of the backend),
    the artifact :func:`bf16_serving_certified` reads.
    """
    from ont_tcrconsensus_tpu_torch.io import simulator
    from ont_tcrconsensus_tpu_torch.models import train

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    err = (0.01, 0.004, 0.004)
    width = train._auto_width(template_len)
    s_max = max(depths)
    main_params = load_params(serving_weights_path())
    low_params = load_low_depth_params()

    def make_polisher(bf16):
        return make_pipeline_polisher(main_params, min_polish_depth=min_polish_depth,
                                      low_depth_params=low_params, low_depth=2, bf16=bf16,
                                      device=device)

    codes = np.full((n_clusters, s_max, width), PAD_CODE, np.uint8)
    lens = np.zeros((n_clusters, s_max), np.int32)
    quals = np.zeros((n_clusters, s_max, width), np.uint8)
    strands = np.zeros((n_clusters, s_max), bool)
    for c in range(n_clusters):
        template = simulator._rand_seq(rng, template_len)
        template_rc = simulator.revcomp(template)
        for i in range(depths[c % len(depths)]):
            r, q, is_rev = train._simulate_oriented_read(
                rng, template, template_rc, err, train.DEFAULT_ERROR_MODEL)
            codes[c, i, : len(r)] = r
            quals[c, i, : len(q)] = q
            lens[c, i] = len(r)
            strands[c, i] = is_rev
    drafts, dlens = consensus_mod.consensus_clusters_batch(
        codes, lens, rounds=4, band_width=consensus_mod.POLISH_BAND_WIDTH, device=device)
    out32, len32 = make_polisher(False)(codes, lens, drafts.copy(), dlens.copy(),
                                        quals=quals, strands=strands)
    out16, len16 = make_polisher(True)(codes, lens, drafts.copy(), dlens.copy(),
                                       quals=quals, strands=strands)
    mismatch = int(np.sum((len32 != len16) | (out32 != out16).any(axis=1)))
    backend, kind = _backend_of(device)
    rec = {
        "backend": backend,
        "device_kind": kind,
        "weights": os.path.basename(serving_weights_path()),
        "low_depth_weights": _current_low_depth_basename(),
        "min_polish_depth": min_polish_depth,
        "identical": mismatch == 0,
        "n_clusters": n_clusters,
        "mismatched_clusters": mismatch,
        "depths": list(depths),
        "template_len": template_len,
        "seed": seed,
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if write:
        with open(out_path or bf16_ab_artifact_path(backend), "w") as fh:
            json.dump(rec, fh, indent=1)
    return rec
