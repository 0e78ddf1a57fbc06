"""Polisher training: the PyTorch port against the JAX package on the same
seeded inputs, at the JAX tests' small size (template 128, width 256).

Tolerances: the single-cluster pileup and consensus, labels, insertion
labels, loss weights, ``save_params`` bytes, ``polish_draft`` and the
evaluations are exactly equal; features to 1e-6 (float32 sums and log1p,
as ``test_torch_polisher.py``); the loss to rtol 1e-5 and every gradient
leaf to 1e-4 of its largest magnitude (torch's GRU backward against XLA's
scan, both float32); after three Adam steps every parameter to atol 1e-4,
a tenth of the learning rate (Adam's normalized update can turn a
rounding-level difference in a near-zero gradient into up to ``lr``)."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402

from ont_tcrconsensus_tpu.models import polisher as jpolisher  # noqa: E402
from ont_tcrconsensus_tpu.models import train as jtrain  # noqa: E402
from ont_tcrconsensus_tpu.ops import consensus as jconsensus  # noqa: E402
from ont_tcrconsensus_tpu.ops import pileup as jpileup  # noqa: E402
from ont_tcrconsensus_tpu_torch import convert  # noqa: E402
from ont_tcrconsensus_tpu_torch.io.dp_cases import noisy_copy  # noqa: E402
from ont_tcrconsensus_tpu_torch.models import polisher, train  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import consensus, encode, pileup  # noqa: E402
from test_torch_e2e import _one_torch_thread  # noqa: E402,F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(template_len=128, width=256)


def _leaves(tree) -> dict:
    return {jtu.keystr(k): np.asarray(v) for k, v in jtu.tree_leaves_with_path(tree)}


def _assert_examples_equal(got, want):
    for f in ("labels", "ins_labels", "mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.feats.dtype == np.float32 and got.feats.shape == want.feats.shape
    np.testing.assert_allclose(got.feats, want.feats, rtol=0, atol=1e-6)


def _cluster(seed: int, depth: int = 5, W: int = 256):
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, 180).astype(np.uint8)
    sub = np.full((depth + 1, W), encode.PAD_CODE, np.uint8)  # one 0-length padding row
    lens = np.zeros(depth + 1, np.int32)
    for s in range(depth):
        read = noisy_copy(rng, tpl, 0.06)[: W - 8]
        sub[s, : len(read)] = read
        lens[s] = len(read)
    return sub, lens


# -- the single-cluster drivers ---------------------------------------------------


def test_pileup_columns_equals_jax():
    sub, lens = _cluster(1)
    draft = sub[0].copy()
    got = pileup.pileup_columns(sub, lens, draft, int(lens[0]), np.zeros(len(lens), np.int32),
                                band_width=64, out_len=256, device="cpu")
    want = jpileup.pileup_columns(sub, lens, jnp.asarray(draft), jnp.int32(lens[0]),
                                  np.zeros(len(lens), np.int32), band_width=64, out_len=256)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # nonzero band centres go through the same forward and traceback
    offs = np.arange(len(lens), dtype=np.int32) - 2
    got = pileup.pileup_columns(sub, lens, draft, int(lens[0]), offs, band_width=64,
                                out_len=256, device="cpu")
    want = jpileup.pileup_columns(sub, lens, jnp.asarray(draft), jnp.int32(lens[0]), offs,
                                  band_width=64, out_len=256)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed,rounds,pad_to", [(2, 4, None), (3, 1, 320), (4, 4, 256)])
def test_consensus_cluster_equals_jax(seed, rounds, pad_to):
    sub, lens = _cluster(seed)
    got = consensus.consensus_cluster(sub, lens, rounds=rounds, band_width=64, pad_to=pad_to,
                                      device="cpu")
    want = jconsensus.consensus_cluster(sub, lens, rounds=rounds, band_width=64, pad_to=pad_to)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    empty = consensus.consensus_cluster(sub, np.zeros_like(lens), device="cpu")
    assert empty[1] == 0 and (empty[0] == encode.PAD_CODE).all()


def test_consensus_cluster_raises_past_the_width():
    """The seed (lower-median length) lacks a base four of five reads
    carry, and the width is the seed's length: the first vote outgrows it."""
    rng = np.random.default_rng(6)
    tpl = rng.integers(0, 4, 120).astype(np.uint8)

    def ins(read, pos, base):
        return np.insert(read, pos, (read[pos - 1] + 1 + base) % 4)

    with_x = ins(tpl, 60, 1)
    reads = [np.delete(with_x, 10), np.delete(with_x, 10), ins(tpl, 30, 2),
             ins(ins(with_x, 95, 0), 30, 2), ins(ins(with_x, 95, 0), 30, 2)]
    sub = np.full((5, 136), encode.PAD_CODE, np.uint8)
    lens = np.array([len(r) for r in reads], np.int32)
    for s, r in enumerate(reads):
        sub[s, : len(r)] = r
    assert lens.tolist() == [120, 120, 121, 123, 123]
    for fn in (jconsensus.consensus_cluster,
               lambda *a, **k: consensus.consensus_cluster(*a, **k, device="cpu")):
        with pytest.raises(ValueError, match="padded width"):
            fn(sub, lens, rounds=2, band_width=64, pad_to=121)


# -- examples -----------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(features="v1"),
    dict(features="v4", qual_dropout=0.5),
    dict(features="v4", depth_dist="lowdepth", error_models=jtrain.TRAIN_REGIMES),
    dict(features="v1", error_model=None),
], ids=("v1", "v4-qual-dropout", "v4-lowdepth-regimes", "v1-iid"))
def test_make_examples_equals_jax(kw):
    n = 6
    port_kw = dict(kw)
    if "error_models" in kw:
        port_kw["error_models"] = train.TRAIN_REGIMES
    want = jtrain.make_examples(seed=3, n_examples=n, **SMALL, **kw)
    got = train.make_examples(seed=3, n_examples=n, **SMALL, **port_kw, device="cpu")
    _assert_examples_equal(got, want)
    assert got.feats.shape[-1] == (25 if kw["features"] == "v4" else 15)


def test_make_examples_in_chunks_equals_one_call(monkeypatch):
    """The pool built a few examples a batched call (the chunking that
    bounds the planes) equals the pool built in one call."""
    whole = train.make_examples(seed=4, n_examples=5, **SMALL, device="cpu")
    monkeypatch.setattr(train, "_POOL_CHUNK", 2)
    _assert_examples_equal(train.make_examples(seed=4, n_examples=5, **SMALL, device="cpu"),
                           whole)


def test_regime_tables_and_helpers_match_jax():
    def fields(models):
        return [None if m is None else dataclasses.asdict(m) for m in models]

    assert fields(train.TRAIN_REGIMES) == fields(jtrain.TRAIN_REGIMES)
    assert list(train.HELDOUT_REGIMES) == list(jtrain.HELDOUT_REGIMES)
    assert fields(train.HELDOUT_REGIMES.values()) == fields(jtrain.HELDOUT_REGIMES.values())
    assert dataclasses.asdict(train.DEFAULT_ERROR_MODEL) == dataclasses.asdict(
        jtrain.DEFAULT_ERROR_MODEL)
    for n in (100, 128, 1300, 1600, 1793):
        assert train._auto_width(n) == jtrain._auto_width(n)
    for dist in ("uniform", "lowdepth"):
        a, b = np.random.default_rng(1), np.random.default_rng(1)
        assert ([train.sample_depth(a, (2, 8), dist) for _ in range(300)]
                == [jtrain.sample_depth(b, (2, 8), dist) for _ in range(300)])
    a, b = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(5):
        g, w = (m._simulate_oriented_read(r, "ACGTTTGCA" * 9, "TGCAAACGT" * 9, (.03, .01, .01),
                                          m.DEFAULT_ERROR_MODEL)
                for m, r in ((train, a), (jtrain, b)))
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2] == w[2]


# -- the network, the loss and training ------------------------------------------------


@pytest.fixture(scope="module")
def pool():
    return train.make_examples(seed=0, n_examples=6, **SMALL, device="cpu")


@pytest.fixture(scope="module")
def start_params():
    return jax.tree_util.tree_map(np.asarray, jpolisher.init_params(0, feature_dim=15))


def test_init_params_matches_flax_structure(start_params):
    for fdim, want in ((15, start_params), (25, jpolisher.init_params(7, feature_dim=25))):
        got = polisher.init_params(7, feature_dim=fdim)
        g, w = _leaves(got), _leaves(want)
        assert list(g) == list(w)
        assert {k: (v.shape, v.dtype) for k, v in g.items()} == {
            k: (v.shape, v.dtype) for k, v in w.items()}
        for path, v in g.items():
            if "bias" in path:
                assert not v.any(), path
            elif any(f"['{h}']" in path for h in ("hr", "hz", "hn")):
                np.testing.assert_allclose(v.T @ v, np.eye(v.shape[1]), atol=1e-5)
            else:  # lecun normal, truncated at two standard deviations
                std = (1.0 / v.shape[0]) ** 0.5 / 0.87962566103423978
                assert np.abs(v).max() <= 2 * std + 1e-6
                assert 0.6 * v.std() < (1.0 / v.shape[0]) ** 0.5 < 1.4 * v.std()
    np.testing.assert_array_equal(polisher.init_params(7)["head"]["kernel"],
                                  polisher.init_params(7)["head"]["kernel"])
    assert not np.array_equal(polisher.init_params(7)["head"]["kernel"],
                              polisher.init_params(8)["head"]["kernel"])


def test_loss_and_gradients_equal_jax(pool, start_params):
    args = (pool.feats[:4], pool.labels[:4], pool.ins_labels[:4], pool.mask[:4])
    jl, jg = jax.value_and_grad(jpolisher.cross_entropy_loss)(
        start_params, *(jnp.asarray(a) for a in args))
    model = polisher.trainable(start_params, device="cpu")
    loss = polisher.cross_entropy_loss(model, *(torch.from_numpy(a) for a in args))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    grads = convert.tree_from_state({n: p.grad for n, p in model.named_parameters()})
    got, want = _leaves(grads), _leaves(jg)
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path].detach().numpy() if isinstance(got[path], torch.Tensor) else got[path]
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), path
    # the r and z hidden biases get no gradient
    for gru in model.grus:
        for name, p in gru.named_parameters():
            if name.startswith("bias_hh"):
                assert not p.grad[: 2 * 96].any()


def test_train_equals_jax_train(pool, start_params):
    kw = dict(steps=3, batch_size=4, lr=1e-3, seed=0, pool_examples=4, log_every=0,
              template_len=128, depth_range=(3, 4))
    want_params, want_losses = jtrain.train(params=start_params, **kw)
    got_params, got_losses = train.train(params=start_params, device="cpu", **kw)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    got, want = _leaves(got_params), _leaves(want_params)
    assert list(got) == list(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-4, err_msg=path)
    assert got_losses[-1] < got_losses[0]


def test_hidden_rz_biases_stay_zero_through_training(pool, start_params):
    model = polisher.trainable(start_params, device="cpu")
    step = polisher.make_train_step(torch.optim.Adam(model.parameters(), lr=1e-2))
    batch = [torch.from_numpy(a) for a in (pool.feats, pool.labels, pool.ins_labels, pool.mask)]
    for _ in range(3):
        step(model, *batch)
    for gru in model.grus:
        for name, p in gru.named_parameters():
            if name.startswith("bias_hh"):
                assert torch.count_nonzero(p[: 2 * 96]) == 0, name
                assert torch.count_nonzero(p[2 * 96:]) > 0, name  # hn's bias learned
    with torch.no_grad():
        model.grus[0].bias_hh_l0[0] = 1.0
    with pytest.raises(ValueError, match="r and z biases"):
        convert.polisher_to_numpy(model)


# -- weights files --------------------------------------------------------------------


@pytest.mark.parametrize("version", ("v3", "v4"))
def test_save_params_writes_the_bundled_bytes(version, tmp_path):
    path = os.path.join(os.path.dirname(polisher.__file__), "weights",
                        f"polisher_{version}.msgpack")
    tree = convert.polisher_to_numpy(
        convert.polisher_from_numpy(polisher.load_params(path), device="cpu"))
    out = tmp_path / "w.msgpack"
    polisher.save_params(tree, str(out))
    with open(path, "rb") as fh:
        assert out.read_bytes() == fh.read()


def test_a_port_written_file_reads_in_jax(tmp_path, start_params):
    params = polisher.init_params(3, feature_dim=25)
    out = tmp_path / "w.msgpack"
    polisher.save_params(params, str(out))
    want = _leaves(params)
    got = _leaves(jpolisher.load_params(str(out)))
    assert list(got) == list(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype
        np.testing.assert_array_equal(got[path], w)
    # a JAX-written file of the same tree has the same bytes
    jout = tmp_path / "j.msgpack"
    jpolisher.save_params(start_params, str(jout))
    polisher.save_params(start_params, str(out))
    assert out.read_bytes() == jout.read_bytes()


# -- serving a trained tree and the evaluations -----------------------------------------


def test_polish_draft_equals_jax(pool):
    params = polisher.load_default_params()
    for i, with_depth in ((0, False), (1, True)):
        draft = np.where(pool.feats[i, :, -4:].sum(-1) > 0,
                         pool.feats[i, :, -4:].argmax(-1), encode.PAD_CODE).astype(np.uint8)
        dlen = int((pool.mask[i] > 0).nonzero()[0].max()) + 1
        dep = np.expm1(pool.feats[i, :, 10]).round() if with_depth else None
        got = polisher.polish_draft(params, pool.feats[i], draft, dlen, depth=dep, device="cpu")
        want = jpolisher.polish_draft(params, pool.feats[i], draft, dlen, depth=dep)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_evaluations_equal_jax(start_params):
    params = jpolisher.load_params(jpolisher.serving_weights_path())
    kw = dict(n_clusters=4, template_len=128, depths=(2, 4), cluster_batch=4)
    got = train.evaluate_consensus_gain(params, device="cpu", **kw)
    want = jtrain.evaluate_consensus_gain(params, **kw)
    assert got == want
    assert train.evaluate_accuracy(params, n_examples=4, device="cpu") == \
        jtrain.evaluate_accuracy(params, n_examples=4)


# -- the CLI --------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [["--v3", "--v4"], ["--iid", "--v4"], []],
                         ids=("v3-and-v4", "iid-with-v4", "default-out-is-served-v3"))
def test_cli_refusals_equal_jax(argv, capsys):
    outs = []
    for main in (train._main, jtrain._main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        outs.append((exc.value.code, capsys.readouterr().err.splitlines()[-1]))
    assert outs[0] == outs[1]
    assert outs[0][0] == 2


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("the host has a card")
    monkeypatch.delenv("TCR_CONSENSUS_FORCE_CPU", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train._main(["--out", str(tmp_path / "w.msgpack"), "--steps", "1"])
    with pytest.raises(SystemExit) as exc:
        train._main(["--cpu", "--resume", "--out", str(tmp_path / "none.msgpack")])
    assert exc.value.code == 2
    assert f"--resume: no weights at {tmp_path / 'none.msgpack'}" in capsys.readouterr().err


def test_cli_cpu_run(tmp_path):
    """The CLI on the CPU writes the weights and the evaluation the library
    calls give (the library calls are held to the JAX package above)."""
    out, ev = tmp_path / "w.msgpack", tmp_path / "eval.json"
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"  # one intra-op thread, as the fixture sets here
    proc = subprocess.run(
        [sys.executable, "-m", "ont_tcrconsensus_tpu_torch.models.train", "--cpu",
         "--steps", "2", "--pool-examples", "2", "--batch-size", "2", "--template-len", "128",
         "--eval-clusters", "1", "--out", str(out), "--eval-json", str(ev)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "training on cpu" in proc.stderr
    assert f"saved {out}" in proc.stdout
    want_params, losses = train.train(steps=2, batch_size=2, pool_examples=2, template_len=128,
                                      log_every=0, device="cpu")
    assert f"(final loss {losses[-1]:.4f})" in proc.stdout
    got = polisher.load_params(str(out))
    polisher.save_params(want_params, str(tmp_path / "want.msgpack"))
    assert out.read_bytes() == (tmp_path / "want.msgpack").read_bytes()
    with open(ev) as fh:
        table = json.load(fh)
    want = train.evaluate_consensus_gain(got, template_len=128, n_clusters=1, device="cpu")
    assert table == {str(k): v for k, v in want.items()}
