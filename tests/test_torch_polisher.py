"""The bi-GRU polisher: the PyTorch port against the JAX package on the same
seeded inputs, at small widths. The weights loader must give Flax's tree
leaf for leaf, the features equal JAX's to 1e-6 (float32 sums and log1p),
the logits equal JAX's to 1e-4 at the real weights (torch's GRU against
XLA's scan), and the polished consensus byte-equal: with the consensus
rounds' kept pileup, with a recomputed one, and with the depth-2 pass."""

import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu_torch import convert  # noqa: E402
from ont_tcrconsensus_tpu_torch.io.dp_cases import noisy_copy  # noqa: E402
from ont_tcrconsensus_tpu_torch.models import polisher  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import consensus, encode  # noqa: E402

try:  # the JAX reference; a card machine without JAX runs the gpu cases only
    import jax
    import jax.numpy as jnp
    from flax.serialization import msgpack_restore

    from ont_tcrconsensus_tpu.models import polisher as jpolisher
    from ont_tcrconsensus_tpu.ops import consensus as jconsensus
except ImportError:
    jax = jnp = msgpack_restore = jpolisher = jconsensus = None

WEIGHTS = os.path.join(os.path.dirname(polisher.__file__), "weights")
BUNDLED = ("polisher_v2.msgpack", "polisher_v3.msgpack", "polisher_v3_eval.json",
           "polisher_v4.msgpack", "polisher_depth_gate_blastid.json")


def _weights(version: str) -> str:
    return os.path.join(WEIGHTS, f"polisher_{version}.msgpack")


@pytest.mark.parametrize("version", ("v2", "v3", "v4"))
def test_msgpack_loader_equals_flax_leaf_for_leaf(version):
    got = polisher.load_params(_weights(version))
    with open(_weights(version), "rb") as fh:
        want = msgpack_restore(fh.read())
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w)
    assert polisher.params_feature_dim(got) == (25 if version == "v4" else 15)


@pytest.mark.parametrize("name", BUNDLED)
def test_bundled_weights_are_the_jax_packages(name):
    jdir = os.path.join(os.path.dirname(jpolisher.__file__), "weights")

    def sha(path):
        with open(path, "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()

    assert sha(os.path.join(WEIGHTS, name)) == sha(os.path.join(jdir, name))


def test_serving_order_matches_the_jax_package():
    assert os.path.basename(polisher.serving_weights_path()) == os.path.basename(
        jpolisher.serving_weights_path()) == "polisher_v3.msgpack"
    assert polisher.load_low_depth_params() is not None
    assert consensus.FEATURE_DIM_V4 == jconsensus.FEATURE_DIM_V4
    assert consensus.QUAL_FILL == jconsensus.QUAL_FILL


def _random_pileup(seed: int, C: int = 4, S: int = 6, W: int = 192):
    """Pileup planes with every code (uncovered, deletion, N), insertions,
    read positions past the qualities' end, and padded drafts."""
    rng = np.random.default_rng(seed)
    base_at = rng.choice(6, p=[.2, .2, .2, .2, .1, .1], size=(C, S, W)).astype(np.uint8)
    ins_cnt = (rng.random((C, S, W)) < 0.2) * rng.integers(1, 4, (C, S, W))
    ins_base = rng.integers(0, 4, (C, S, W)).astype(np.uint8)
    pos_at = np.where(base_at < 4, rng.integers(-1, W + 8, (C, S, W)), -1).astype(np.int32)
    quals = rng.integers(0, 42, (C, S, W)).astype(np.uint8)
    is_rev = rng.random((C, S)) < 0.5
    drafts = rng.integers(0, 6, (C, W)).astype(np.uint8)
    return base_at, ins_cnt.astype(np.int32), ins_base, pos_at, quals, is_rev, drafts


@pytest.mark.parametrize("v4", (False, True), ids=("v1", "v4"))
def test_pileup_features_match_jax(v4):
    base_at, ins_cnt, ins_base, pos_at, quals, is_rev, drafts = _random_pileup(3)
    t = [torch.from_numpy(x) for x in (base_at, ins_cnt, ins_base, drafts)]
    if v4:
        got = consensus.pileup_features_v4(*t, torch.from_numpy(pos_at),
                                           torch.from_numpy(quals), torch.from_numpy(is_rev))
        want = jax.vmap(jconsensus.pileup_features_v4)(
            base_at, ins_cnt, ins_base, drafts, pos_at, quals, is_rev)
    else:
        got = consensus.pileup_features(*t)
        want = jax.vmap(jconsensus.pileup_features)(base_at, ins_cnt, ins_base, drafts)
    assert got.dtype == torch.float32
    assert got.shape == (4, 192, 25 if v4 else 15)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("version", ("v3", "v4"))
def test_logits_match_apply_logits(version):
    """The real weights on features of random pileup planes: torch's GRU
    against XLA's scan."""
    params = polisher.load_params(_weights(version))
    base_at, ins_cnt, ins_base, pos_at, quals, is_rev, drafts = _random_pileup(5, C=3, W=256)
    args = (base_at, ins_cnt, ins_base, drafts)
    if version == "v4":
        feats = np.array(jax.vmap(jconsensus.pileup_features_v4)(*args, pos_at, quals, is_rev))
    else:
        feats = np.array(jax.vmap(jconsensus.pileup_features)(*args))
    model = convert.polisher_from_numpy(params, device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(feats)).numpy()
    want = np.asarray(jpolisher.apply_logits(params, jnp.asarray(feats)))
    assert got.shape == (3, 256, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _cluster_tile(seed: int, depths=(6, 4, 2, 5), W: int = 256):
    """(C, S, W) clusters of noisy copies of one template each, a third of
    them one base short in a homopolymer run (ONT's dominant error), with
    qualities and strands; cluster c has ``depths[c]`` of S = 8 slots."""
    rng = np.random.default_rng(seed)
    C, S = len(depths), 8
    sub = np.full((C, S, W), encode.PAD_CODE, np.uint8)
    lens = np.zeros((C, S), np.int32)
    quals = np.zeros((C, S, W), np.uint8)
    strands = np.zeros((C, S), bool)
    for c, depth in enumerate(depths):
        tpl = rng.integers(0, 4, int(rng.integers(W - 110, W - 60))).astype(np.uint8)
        tpl[20:27] = c % 4  # a homopolymer run, which ONT reads shorten
        for s in range(depth):
            read = noisy_copy(rng, tpl, 0.05)[: W - 8]
            if s % 3 == 0:
                read = np.delete(read, 22)
            sub[c, s, : len(read)] = read
            lens[c, s] = len(read)
            quals[c, s, : len(read)] = rng.integers(4, 40, len(read))
            strands[c, s] = bool(rng.random() < 0.5)
    return sub, lens, quals, strands


def _jax_polish(sub, lens, quals, strands, pileup_mode, low_depth):
    params = jpolisher.load_params(jpolisher.serving_weights_path())
    low = jpolisher.load_low_depth_params() if low_depth else None
    pol = jpolisher.make_pipeline_polisher(params, low_depth_params=low)
    drafts, dlens, pileup = jconsensus.consensus_clusters_batch(
        sub, lens, rounds=4, band_width=64, keep_final_pileup=True, keep_pos=pol.wants_v4)
    assert pileup is not None
    out, out_lens = pol(sub, lens, np.asarray(drafts), np.asarray(dlens),
                        pileup=pileup if pileup_mode == "kept" else None, band_width=64,
                        quals=quals, strands=strands)
    return np.asarray(drafts), np.asarray(dlens), np.asarray(out), np.asarray(out_lens)


def _port_polish(sub, lens, quals, strands, pileup_mode, low_depth, device="cpu"):
    params = polisher.load_default_params()
    low = polisher.load_low_depth_params() if low_depth else None
    pol = polisher.make_pipeline_polisher(params, low_depth_params=low, device=device)
    drafts, dlens, pileup = consensus.consensus_clusters_batch(
        sub, lens, rounds=4, band_width=64, keep_final_pileup=True, keep_pos=pol.wants_v4,
        device=device)
    assert pileup is not None
    out, out_lens = pol(sub, lens, drafts, dlens,
                        pileup=pileup if pileup_mode == "kept" else None, band_width=64,
                        quals=quals, strands=strands)
    return drafts, dlens, out, out_lens


@pytest.mark.parametrize("pileup_mode,low_depth", [
    ("kept", False), ("recomputed", False), ("kept", True), ("recomputed", True),
])
def test_pipeline_polisher_is_byte_equal_to_jax(pileup_mode, low_depth):
    sub, lens, quals, strands = _cluster_tile(11)
    jd, jl, jout, jlens = _jax_polish(sub, lens, quals, strands, pileup_mode, low_depth)
    td, tl, tout, tlens = _port_polish(sub, lens, quals, strands, pileup_mode, low_depth)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tlens, jlens)
    np.testing.assert_array_equal(tout, jout)
    # the network changed something: a consensus, or the depth-2 cluster
    changed = (tlens != tl) | (tout != td).any(axis=1)
    assert changed.any()
    if low_depth:
        assert changed[2]  # the depth-2 cluster, below the main depth gate


def test_reused_pileup_equals_recomputed_and_quals_default_to_the_fill():
    """The kept final pileup is the pileup of the final drafts; v4 weights
    with no qualities read QUAL_FILL everywhere."""
    sub, lens, quals, strands = _cluster_tile(12, depths=(5, 2, 7))
    kept = _port_polish(sub, lens, quals, strands, "kept", True)
    again = _port_polish(sub, lens, quals, strands, "recomputed", True)
    for a, b in zip(kept, again):
        np.testing.assert_array_equal(a, b)
    fill = np.full_like(quals, consensus.QUAL_FILL)
    np.testing.assert_array_equal(
        _port_polish(sub, lens, None, None, "kept", True)[2],
        _port_polish(sub, lens, fill, np.zeros_like(strands), "kept", True)[2])


@pytest.mark.gpu
def test_polisher_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B2 has no CPU mode")
    sub, lens, quals, strands = _cluster_tile(14, depths=(6, 2, 4, 8, 5, 3), W=1024)
    for mode, low_depth in (("kept", False), ("kept", True), ("recomputed", True)):
        got = _port_polish(sub, lens, quals, strands, mode, low_depth, device="cuda")
        want = _port_polish(sub, lens, quals, strands, mode, low_depth, device="cpu")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    params = polisher.load_default_params()
    feats = torch.from_numpy(
        np.random.default_rng(1).normal(size=(4, 1024, 15)).astype(np.float32))
    with torch.inference_mode():
        on_card = convert.polisher_from_numpy(params, device="cuda")(feats.cuda()).cpu()
        on_cpu = convert.polisher_from_numpy(params, device="cpu")(feats)
    torch.testing.assert_close(on_card, on_cpu, rtol=1e-4, atol=1e-4)
