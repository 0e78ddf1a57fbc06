"""Polisher training on the simulator's ONT error models.

The counterpart of the JAX package's ``models/train.py``. Examples are
real pipeline states: a low-depth vote consensus (which still carries
residual errors) and its pileup features, labelled by aligning the true
template to that draft, so the network learns the errors the vote leaves.
Training and evaluation default to the systematic
:class:`..io.simulator.OntErrorModel` (homopolymer-length-dependent
indels, context-biased substitutions, strand asymmetry).

:func:`make_examples` draws every random number of the pool first, in the
JAX package's order, and then builds the pool's consensus, pileups and
labels in batched calls (kernel B2 on the card): each example equals the
JAX function's, which runs one cluster at a time. The evaluation batches
the same way. :func:`train` steps ``torch.optim.Adam`` through
``models.polisher.make_train_step``.

``python -m ont_tcrconsensus_tpu_torch.models.train`` retrains and
evaluates, on the card unless ``--cpu`` or ``TCR_CONSENSUS_FORCE_CPU``
asks for the CPU; its default ``--out`` is the file the pipeline serves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ont_tcrconsensus_tpu_torch.device import resolve_device
from ont_tcrconsensus_tpu_torch.io import simulator
from ont_tcrconsensus_tpu_torch.models import polisher
from ont_tcrconsensus_tpu_torch.ops import consensus, encode, pileup

# training/eval default: the systematic error model at ONT-sup-like rates
DEFAULT_ERROR_MODEL = simulator.OntErrorModel()

# the v3 family: training cycles over these parameterizations, and the
# evaluation's held-out regimes lie outside their ranges
TRAIN_REGIMES: tuple[simulator.OntErrorModel, ...] = (
    simulator.OntErrorModel(),
    simulator.OntErrorModel(sub_rate=0.009, ins_rate=0.003, del_rate=0.006),
    simulator.OntErrorModel(hp_slope=0.6, hp_cap=6.0),
    simulator.OntErrorModel(
        motif_sub_boost=(("GA", 2.0), ("CT", 3.5), ("TC", 1.5)),
        transition_frac=0.75,
    ),
    # the homopolymer axis widened upward, short of the held-out 1.6
    simulator.OntErrorModel(hp_slope=1.3, hp_cap=12.0, del_rate=0.005),
)

# held out: parameters outside the training family's ranges and contexts
HELDOUT_REGIMES: dict[str, simulator.OntErrorModel | None] = {
    # stronger homopolymer shrinkage than any training regime
    "hp_shift": simulator.OntErrorModel(hp_slope=1.6, hp_cap=14.0, del_rate=0.006),
    # a context-bias family disjoint from training's, a lower transition fraction
    "ctx_shift": simulator.OntErrorModel(
        motif_sub_boost=(("AG", 3.0), ("TG", 2.5), ("CA", 2.0)),
        transition_frac=0.4,
    ),
    # no systematic structure at all (iid rates)
    "iid": None,
    # the v2 regime
    "in_family": simulator.OntErrorModel(),
}

# examples a batched call of make_examples builds at once (bounds the
# pileup planes: 128 examples x 8 subreads x 2048 x 64 x 2 B = 268 MB)
_POOL_CHUNK = 128


@dataclasses.dataclass
class ExampleBatch:
    feats: np.ndarray       # (N, W, F) float32: F=15 (v1) or 25 (v4 strand+qual)
    labels: np.ndarray      # (N, W) int32: 0-3 base, 4 deletion
    ins_labels: np.ndarray  # (N, W) int32: 0 none, 1-4 insert A/C/G/T after
    mask: np.ndarray        # (N, W) float32: loss weight, 0 where unsupervised


def _auto_width(template_len: int) -> int:
    """Smallest power of two fitting the template plus indel growth and a
    vote-splice margin (>= template_len + 256)."""
    return 1 << (int(template_len) + 255).bit_length()


def _simulate_oriented_read(rng, template: str, template_rc: str, err, error_model):
    """One subread as the pipeline sees it: sequenced in a random
    orientation (systematic errors hit the sequenced strand), then turned
    back to the canonical (+) strand with its qualities reversed.

    Returns (codes uint8, quals uint8 phred, is_rev bool).
    """
    is_rev = bool(rng.random() < 0.5)
    src = template_rc if is_rev else template
    if error_model is not None:
        s, q = simulator.mutate_ont(rng, src, error_model)
    else:
        s, q = simulator.mutate(rng, src, *err)
    codes = encode.encode_seq(s)
    quals = np.frombuffer(q.encode("ascii"), np.uint8).astype(np.int32) - 33
    quals = np.clip(quals, 0, 255).astype(np.uint8)
    if is_rev:
        codes = encode.revcomp_codes(codes)
        quals = quals[::-1]
    return codes, quals, is_rev


def sample_depth(rng, depth_range: tuple[int, int], depth_dist: str = "uniform") -> int:
    """A cluster depth in ``depth_range``. ``lowdepth`` puts 70% of the
    draws at depth 2-4 (where vote consensus loses molecules) and the rest
    uniform from 5 to the maximum, so deep clusters stay in distribution."""
    lo, hi = depth_range
    low_band = [d for d in (2, 3, 4) if lo <= d <= hi]
    if depth_dist == "lowdepth" and low_band and hi >= 5:
        if rng.random() < 0.7:
            return int(rng.choice(low_band))
        return int(rng.integers(5, hi + 1))
    return int(rng.integers(lo, hi + 1))


def _draw_reads(rng, template: str, depth: int, width: int, err, error_model):
    """``depth`` oriented subreads of ``template`` (:func:`_simulate_oriented_read`):
    (codes (depth, width), lens, quals (depth, width), strands)."""
    template_rc = simulator.revcomp(template)
    codes = np.full((depth, width), encode.PAD_CODE, np.uint8)
    lens = np.zeros(depth, np.int32)
    quals = np.zeros((depth, width), np.uint8)
    strands = np.zeros(depth, bool)
    for i in range(depth):
        r, q, is_rev = _simulate_oriented_read(rng, template, template_rc, err, error_model)
        codes[i, : len(r)] = r
        quals[i, : len(q)] = q
        lens[i] = len(r)
        strands[i] = is_rev
    return codes, lens, quals, strands


def _stack_clusters(clusters, width: int):
    """(C, S, width) codes and quals, (C, S) lens and strands, S the
    deepest cluster's depth; shallower clusters get 0-length rows, which
    cover no column, vote nowhere and are never a seed."""
    S = max(c[0].shape[0] for c in clusters)
    C = len(clusters)
    codes = np.full((C, S, width), encode.PAD_CODE, np.uint8)
    lens = np.zeros((C, S), np.int32)
    quals = np.zeros((C, S, width), np.uint8)
    strands = np.zeros((C, S), bool)
    for c, (cc, ll, qq, ss) in enumerate(clusters):
        d = cc.shape[0]
        codes[c, :d], lens[c, :d], quals[c, :d], strands[c, :d] = cc, ll, qq, ss
    return codes, lens, quals, strands


def _examples_of(drawn, width: int, band_width: int, rounds: int, err_weight: float,
                 features: str, device: torch.device):
    """Labelled examples of drawn clusters (truth, codes, lens, quals,
    strands), built in batched calls: the vote consensus with its final
    pileup kept, the features, and the truth aligned to every draft at
    once. Returns (feats, labels, ins_labels, mask) of the clusters whose
    draft is not empty."""
    v4 = features == "v4"
    codes, lens, quals, strands = _stack_clusters([d[1:] for d in drawn], width)
    drafts, dlens, pile = consensus.consensus_clusters_batch(
        codes, lens, rounds=rounds, band_width=band_width, keep_final_pileup=True,
        keep_pos=v4, device=device)
    d_drafts = torch.from_numpy(drafts).to(device)
    d_dlens = torch.from_numpy(dlens).to(device)
    if pile is None:  # the rounds ran out with a draft still changing
        pile = pileup.pileup_columns_batch_auto(
            torch.from_numpy(codes).to(device), torch.from_numpy(lens).to(device),
            d_drafts, d_dlens, band_width=band_width, out_len=width)[:4]
    base_at, ins_cnt, ins_base, pos_at = pile
    if v4:
        feats = consensus.pileup_features_v4(
            base_at, ins_cnt, ins_base, d_drafts, pos_at,
            torch.from_numpy(quals).to(device), torch.from_numpy(strands).to(device))
    else:
        feats = consensus.pileup_features(base_at, ins_cnt, ins_base, d_drafts)

    # label by aligning each truth to its draft
    C = len(drawn)
    tcodes = np.full((C, 1, width), encode.PAD_CODE, np.uint8)
    tlens = np.zeros((C, 1), np.int32)
    for c, d in enumerate(drawn):
        tcodes[c, 0, : len(d[0])] = d[0]
        tlens[c, 0] = len(d[0])
    t_base, t_ins_cnt, t_ins_base, _, _ = pileup.pileup_columns_batch_auto(
        torch.from_numpy(tcodes).to(device), torch.from_numpy(tlens).to(device),
        d_drafts, d_dlens, band_width=band_width, out_len=width)
    feats, t_base, t_ins_cnt, t_ins_base = (
        x.cpu().numpy() for x in (feats, t_base[:, 0], t_ins_cnt[:, 0], t_ins_base[:, 0]))
    covered = t_base != pileup.UNCOVERED
    labels = np.where(covered, t_base, 0).astype(np.int32)
    ins_labels = np.where(covered & (t_ins_cnt > 0),
                          t_ins_base.astype(np.int32) + 1, 0).astype(np.int32)
    supervised = covered & (np.arange(width)[None, :] < dlens[:, None])
    disagree = supervised & ((labels != drafts.astype(np.int32)) | (ins_labels > 0))
    mask = (np.where(disagree, float(err_weight), 1.0).astype(np.float32)
            * supervised.astype(np.float32))
    keep = dlens > 0
    return feats[keep], labels[keep], ins_labels[keep], mask[keep]


def make_examples(
    seed: int,
    n_examples: int,
    template_len: int = 256,
    depth_range: tuple[int, int] = (2, 8),
    err: tuple[float, float, float] = (0.03, 0.015, 0.015),
    width: int | None = None,
    band_width: int = consensus.POLISH_BAND_WIDTH,
    error_model: simulator.OntErrorModel | None = DEFAULT_ERROR_MODEL,
    rounds: int = 4,
    err_weight: float = 50.0,
    error_models: tuple | None = None,
    features: str = "v1",
    qual_dropout: float = 0.15,
    depth_dist: str = "uniform",
    device: str | torch.device | None = None,
) -> ExampleBatch:
    """Supervised examples from simulated low-depth clusters, built on
    ``device`` (the card when None).

    Per draft position: the true base (0-3), or 4 where the draft holds a
    base the truth lacks (``labels``); the base the draft missed after the
    position, from the truth alignment's insertion columns (``ins_labels``);
    and a loss weight (``mask``): 0 where the truth alignment does not
    cover the draft, ``err_weight`` where the draft disagrees with the
    truth or misses an insertion (about 1% of positions, which an
    unweighted loss would leave the model to copy), 1 elsewhere. Drafts
    are converged vote consensus (``rounds``), as the pipeline serves
    them.

    Subreads are sequenced in a random orientation. ``features="v4"``
    builds the 25-channel strand and quality features; ``qual_dropout``
    replaces a fraction of examples' qualities with ``QUAL_FILL`` (the
    no-qualities serving regime); ``depth_dist="lowdepth"`` draws depths
    with :func:`sample_depth`; ``error_models`` cycles the regimes over
    the examples; ``error_model=None`` uses the iid ``err`` rates. An
    example whose draft is empty is skipped, as in the JAX package.
    """
    device = resolve_device(device)
    if width is None:
        width = _auto_width(template_len)
    rng = np.random.default_rng(seed)
    parts = []
    for start in range(0, n_examples, _POOL_CHUNK):
        drawn = []
        for n in range(start, min(start + _POOL_CHUNK, n_examples)):
            # template, depth, reads, dropout coin: the JAX package's order
            template = simulator._rand_seq(rng, template_len)
            depth = sample_depth(rng, depth_range, depth_dist)
            em = error_models[n % len(error_models)] if error_models else error_model
            codes, lens, quals, strands = _draw_reads(rng, template, depth, width, err, em)
            if rng.random() < qual_dropout:
                # the no-quals serving regime: constant fill on the real rows
                quals = np.where(np.arange(width)[None, :] < lens[:, None],
                                 consensus.QUAL_FILL, 0).astype(np.uint8)
            drawn.append((encode.encode_seq(template), codes, lens, quals, strands))
        parts.append(_examples_of(drawn, width, band_width, rounds, err_weight, features,
                                  device))
    feats, labels, ins_labels, mask = (np.concatenate(x) for x in zip(*parts))
    return ExampleBatch(feats=feats, labels=labels, ins_labels=ins_labels, mask=mask)


def train(
    steps: int = 300,
    batch_size: int = 16,
    lr: float = 1e-3,
    seed: int = 0,
    pool_examples: int = 192,
    template_len: int = 256,
    params=None,
    log_every: int = 50,
    error_model: simulator.OntErrorModel | None = DEFAULT_ERROR_MODEL,
    error_models: tuple | None = None,
    depth_range: tuple[int, int] = (2, 8),
    features: str = "v1",
    depth_dist: str = "uniform",
    device: str | torch.device | None = None,
    pool: ExampleBatch | None = None,
) -> tuple[dict, list[float]]:
    """Train the polisher on ``device`` (the card when None); returns
    (params, the loss of every step), params in Flax's layout.

    The pool is ``make_examples(seed, pool_examples, ...)`` unless
    ``pool`` is given; each step's batch is ``batch_size`` indices drawn
    from ``numpy.random.default_rng(seed + 1)``. ``params`` None starts
    from :func:`..polisher.init_params`. Adam (b1 0.9, b2 0.999, eps 1e-8)
    at ``lr``, the JAX package's ``optax.adam``.
    """
    device = resolve_device(device)
    if pool is None:
        pool = make_examples(
            seed, pool_examples, template_len=template_len, error_model=error_model,
            error_models=error_models, depth_range=depth_range, features=features,
            depth_dist=depth_dist, device=device,
        )
    if params is None:
        params = polisher.init_params(seed, feature_dim=pool.feats.shape[-1])
    model = polisher.trainable(params, device=device)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    step_fn = polisher.make_train_step(optimizer)
    rng = np.random.default_rng(seed + 1)
    losses = []
    for s in range(steps):
        idx = rng.integers(0, pool.feats.shape[0], size=batch_size)
        loss = float(step_fn(model, *(torch.from_numpy(a[idx]).to(device) for a in (
            pool.feats, pool.labels, pool.ins_labels, pool.mask))))
        losses.append(loss)
        if log_every and s % log_every == 0:
            print(f"step {s}: loss {loss:.4f}")
    from ont_tcrconsensus_tpu_torch import convert

    return convert.polisher_to_numpy(model), losses


def evaluate_consensus_gain(
    params,
    seed: int = 101,
    n_clusters: int = 500,
    template_len: int = 1600,
    depths: tuple[int, ...] = (2, 3, 4, 6, 10),
    err: tuple[float, float, float] = (0.01, 0.004, 0.004),
    band_width: int = consensus.POLISH_BAND_WIDTH,
    min_confidence: float = 0.9,
    error_model: simulator.OntErrorModel | None = DEFAULT_ERROR_MODEL,
    cluster_batch: int = 16,
    min_polish_depth: int = 4,
    polish_iterations: int = 1,
    device: str | torch.device | None = None,
) -> dict[int, dict[str, float]]:
    """Precision at depth, vote only against vote + polisher, with the
    polisher's firing counted, on ``device`` (the card when None).

    For each subread depth: the fraction of simulated clusters whose
    consensus equals the true template, after the vote alone
    (``vote_exact``) and after the gated polisher (``rnn_exact``); the
    clusters the polisher changed (``changed_frac``), the positions it
    changed per cluster (``edits_per_cluster``: length change plus
    mismatches on the overlap), and the clusters it moved from wrong to
    exact (``fixed``) and back (``broke``).

    The clusters are drawn as the JAX package draws them (depth by depth,
    ``cluster_batch`` at a time); the k-th batch of every depth then goes
    through the consensus and the polisher together, deeper clusters'
    extra subread rows padding the shallower ones.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    width = _auto_width(template_len)
    polish = polisher.make_pipeline_polisher(
        params, band_width=band_width, min_confidence=min_confidence,
        min_polish_depth=min_polish_depth, iterations=polish_iterations, device=device)
    batches: dict[int, list] = {}  # k -> [(depth, cluster), ...] of every depth's k-th batch
    for depth in depths:
        done = k = 0
        while done < n_clusters:
            cb = min(cluster_batch, n_clusters - done)
            for _ in range(cb):
                template = simulator._rand_seq(rng, template_len)
                reads = _draw_reads(rng, template, depth, width, err, error_model)
                batches.setdefault(k, []).append((depth, (encode.encode_seq(template), *reads)))
            done += cb
            k += 1
    tally = {d: dict(vote_ok=0, rnn_ok=0, changed=0, edits=0, fixed=0, broke=0) for d in depths}
    for k in sorted(batches):
        members = batches[k]
        codes, lens, quals, strands = _stack_clusters([c[1:] for _, c in members], width)
        drafts, dlens = consensus.consensus_clusters_batch(
            codes, lens, rounds=4, band_width=band_width, device=device)
        pol, plens = polish(codes, lens, drafts, dlens, quals=quals, strands=strands)
        for c, (depth, cluster) in enumerate(members):
            truth, t = cluster[0], tally[depth]
            v_ok = dlens[c] == len(truth) and (drafts[c, : dlens[c]] == truth).all()
            r_ok = plens[c] == len(truth) and (pol[c, : plens[c]] == truth).all()
            t["vote_ok"] += v_ok
            t["rnn_ok"] += r_ok
            same = plens[c] == dlens[c] and (pol[c, : plens[c]] == drafts[c, : dlens[c]]).all()
            if not same:
                t["changed"] += 1
                ov = min(int(plens[c]), int(dlens[c]))
                t["edits"] += abs(int(plens[c]) - int(dlens[c])) + int(
                    (pol[c, :ov] != drafts[c, :ov]).sum())
            t["fixed"] += (not v_ok) and r_ok
            t["broke"] += v_ok and (not r_ok)
    return {
        depth: {
            "n": int(n_clusters),
            "vote_exact": float(t["vote_ok"] / n_clusters),
            "rnn_exact": float(t["rnn_ok"] / n_clusters),
            "changed_frac": float(t["changed"] / n_clusters),
            "edits_per_cluster": float(t["edits"] / n_clusters),
            "fixed": int(t["fixed"]),
            "broke": int(t["broke"]),
        }
        for depth, t in tally.items()
    }


def evaluate_regimes(
    params,
    regimes: dict[str, simulator.OntErrorModel | None] = None,
    seed: int = 101,
    n_clusters: int = 250,
    template_len: int = 1600,
    depths: tuple[int, ...] = (2, 3, 4, 6, 10),
    min_confidence: float = 0.9,
    min_polish_depth: int = 3,
    device: str | torch.device | None = None,
) -> dict:
    """Precision-at-depth tables (:func:`evaluate_consensus_gain`) on
    held-out error regimes (default :data:`HELDOUT_REGIMES`), a seed each
    (``seed + 31 * i`` in sorted order). ``min_polish_depth`` defaults
    one below the serving gate so the depth-3 rows measure the gate's
    tradeoff; ``_meta`` records the gate used."""
    if regimes is None:
        regimes = HELDOUT_REGIMES
    out: dict = {"_meta": {
        "min_polish_depth": min_polish_depth,
        "min_confidence": min_confidence,
        "n_clusters": n_clusters, "template_len": template_len,
        "note": "depth rows below the serving min_polish_depth (4) are "
                f"measured with the eval gate ({min_polish_depth}); "
                "serving keeps vote consensus there unless the config "
                "lowers the gate",
    }}
    for i, (name, model) in enumerate(sorted(regimes.items())):
        out[name] = evaluate_consensus_gain(
            params, seed=seed + 31 * i, n_clusters=n_clusters,
            template_len=template_len, depths=depths,
            error_model=model, min_confidence=min_confidence,
            min_polish_depth=min_polish_depth, device=device,
        )
    return out


def evaluate_accuracy(params, seed: int = 99, n_examples: int = 32,
                      device: str | torch.device | None = None) -> dict[str, float]:
    """Per-position accuracy of the polisher against the raw draft on
    held-out examples (:func:`make_examples`), on ``device`` (the card
    when None): the class head (``model_acc``), the draft's own base
    (``draft_acc``; the draft one-hot is the last four feature channels
    of both encodings) and the insertion head (``ins_acc``), over the
    supervised positions."""
    fdim = polisher.params_feature_dim(params)
    ex = make_examples(seed, n_examples,
                       features="v4" if fdim == consensus.FEATURE_DIM_V4 else "v1",
                       device=device)
    with torch.inference_mode():
        logits = polisher.apply_logits(params, torch.from_numpy(ex.feats),
                                       device=device).cpu().numpy()
    pred = logits[..., : polisher.NUM_CLASSES].argmax(axis=-1)
    m = ex.mask > 0
    model_acc = float((pred[m] == ex.labels[m]).mean())
    draft_base = ex.feats[..., -4:].argmax(axis=-1)
    draft_is_base = ex.feats[..., -4:].sum(axis=-1) > 0
    base_acc = float(((draft_base[m] == ex.labels[m]) & draft_is_base[m]).mean())
    ins_pred = logits[..., polisher.NUM_CLASSES:].argmax(axis=-1)
    ins_acc = float((ins_pred[m] == ex.ins_labels[m]).mean())
    return {"model_acc": model_acc, "draft_acc": base_acc, "ins_acc": ins_acc}


def _main(argv=None) -> int:
    """``python -m ont_tcrconsensus_tpu_torch.models.train``: retrain and
    evaluate.

    Trains at pipeline template lengths on the systematic ONT error model,
    writes the weights, and prints the vote-against-polisher
    precision-at-depth table. Runs on the card unless ``--cpu`` or
    ``TCR_CONSENSUS_FORCE_CPU`` asks for the CPU; without a card it
    raises. The default ``--out`` is the weights file the pipeline serves.
    """
    import argparse
    import json
    import os
    import sys

    parser = argparse.ArgumentParser(description="Train the consensus polisher.")
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--template-len", type=int, default=1600)
    parser.add_argument("--pool-examples", type=int, default=128)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None,
                        help="weights path (default: the file the pipeline "
                             "serves — polisher.serving_weights_path())")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--eval-clusters", type=int, default=500)
    parser.add_argument("--iid", action="store_true",
                        help="legacy iid error model (ablation only)")
    parser.add_argument("--v3", action="store_true",
                        help="v3 flow: train on the randomized regime "
                             "family, evaluate on held-out regimes, write "
                             "polisher_v3.msgpack + polisher_v3_eval.json")
    parser.add_argument("--v4", action="store_true",
                        help="v4 flow: the v3 regime family PLUS the "
                             "25-channel strand+quality features and a "
                             "low-depth-dominant (2-4) example mix; writes "
                             "polisher_v4.msgpack + polisher_v4_eval.json")
    parser.add_argument("--eval-json", default=None,
                        help="also write the eval table to this path")
    parser.add_argument("--depth-max", type=int, default=8,
                        help="max subread depth in training examples")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the CUDA card)")
    parser.add_argument("--resume", action="store_true",
                        help="warm-start from the existing --out weights")
    args = parser.parse_args(argv)

    if (args.v3 or args.v4) and args.iid:
        parser.error("--v3/--v4 train on the regime family; --iid is the "
                     "single-regime ablation — pick one")
    if args.v3 and args.v4:
        parser.error("pick ONE of --v3 / --v4")
    weights_dir = os.path.dirname(polisher.DEFAULT_WEIGHTS)
    if args.out is None:
        if args.v4:
            args.out = os.path.join(weights_dir, "polisher_v4.msgpack")
        elif args.v3:
            args.out = os.path.join(weights_dir, "polisher_v3.msgpack")
        else:
            # the file the pipeline serves, so a default retrain never
            # writes weights nothing reads
            args.out = polisher.serving_weights_path()
            base = os.path.basename(args.out)
            if base not in ("polisher_v2.msgpack",):
                # a plain retrain would overwrite regime-family weights with
                # single-regime ones and orphan their _eval.json
                parser.error(
                    f"default --out resolves to the served weights "
                    f"{base}, which were trained with the "
                    f"{'--v4' if 'v4' in base else '--v3'} flow; pass "
                    f"that flag to retrain them, or an explicit --out "
                    f"for a single-regime experiment"
                )
    if (args.v3 or args.v4) and args.eval_json is None:
        # beside --out, so an experiment never overwrites the bundled evidence
        args.eval_json = os.path.splitext(args.out)[0] + "_eval.json"
    device = resolve_device(
        "cpu" if args.cpu or os.environ.get("TCR_CONSENSUS_FORCE_CPU") else None)
    print(f"training on {device}", file=sys.stderr)

    error_model = None if args.iid else DEFAULT_ERROR_MODEL
    if args.eval_only:
        params = polisher.load_params(args.out)
    else:
        init = None
        if args.resume:
            if not os.path.exists(args.out):
                parser.error(f"--resume: no weights at {args.out}")
            init = polisher.load_params(args.out)
            print(f"warm-starting from {args.out}")
            if args.seed == 0:
                print("WARNING: --resume with the default --seed replays "
                      "the IDENTICAL example pool and batch order as the "
                      "original run — pass a new --seed to continue on "
                      "fresh data", file=sys.stderr)
        params, losses = train(
            steps=args.steps, batch_size=args.batch_size, seed=args.seed,
            pool_examples=args.pool_examples, template_len=args.template_len,
            params=init,
            error_model=error_model,
            error_models=TRAIN_REGIMES if (args.v3 or args.v4) else None,
            depth_range=(2, args.depth_max),
            features="v4" if args.v4 else "v1",
            depth_dist="lowdepth" if args.v4 else "uniform",
            device=device,
        )
        polisher.save_params(params, args.out)
        print(f"saved {args.out} (final loss {losses[-1]:.4f})")
    if args.v3 or args.v4:
        gain = evaluate_regimes(params, template_len=args.template_len,
                                n_clusters=args.eval_clusters, device=device)
    else:
        gain = evaluate_consensus_gain(params, template_len=args.template_len,
                                       n_clusters=args.eval_clusters,
                                       error_model=error_model, device=device)
    print(json.dumps(gain, indent=2))
    if args.eval_json:
        with open(args.eval_json, "w") as fh:
            json.dump(gain, fh, indent=2)
        print(f"wrote {args.eval_json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
