"""The polisher's training layout on the port's mesh against the JAX
package's, on CPU slices (the JAX package's eight virtual devices).

``polisher_param_sharding`` must give JAX's spec leaf for leaf, with and
without a ``model`` axis. ``sharded_train_step`` at ``{"data": 2}`` and
``{"data": 2, "model": 2}`` must give the unsharded step's loss and
parameters exactly (the pieces only move; the step is the same float32
program on the same batch), keep the r and z hidden biases zero, and
charge ``transfer.h2d`` the bytes JAX's placement charges its devices."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.tree_util as jtu  # noqa: E402
import optax  # noqa: E402

from ont_tcrconsensus_tpu.models import polisher as jpolisher  # noqa: E402
from ont_tcrconsensus_tpu.obs import metrics as jmetrics  # noqa: E402
from ont_tcrconsensus_tpu.parallel import mesh as jmesh  # noqa: E402
from ont_tcrconsensus_tpu_torch import convert  # noqa: E402
from ont_tcrconsensus_tpu_torch.models import polisher, train  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from ont_tcrconsensus_tpu_torch.parallel import mesh  # noqa: E402
from test_torch_e2e import _one_torch_thread  # noqa: E402,F401  (autouse)

SHAPES = ({"data": 2}, {"data": 2, "model": 2})


@pytest.fixture(autouse=True)
def _cpu_slices():
    assert len(jax.devices()) == 8
    mesh.install_slice_devices(["cpu"] * 8)
    yield
    mesh.install_slice_devices(None)


@pytest.fixture(scope="module")
def batch():
    ex = train.make_examples(seed=5, n_examples=4, template_len=128, width=256, device="cpu")
    return ex.feats, ex.labels, ex.ins_labels, ex.mask


@pytest.mark.parametrize("shape", SHAPES, ids=("data2", "data2-model2"))
@pytest.mark.parametrize("fdim", (15, 25))
def test_param_sharding_plan_equals_jax(shape, fdim):
    params = polisher.init_params(0, feature_dim=fdim)
    got = mesh.polisher_param_sharding(mesh.make_mesh(shape, device="cpu"), params)
    want = jmesh.polisher_param_sharding(jmesh.make_mesh(shape), params)
    g = {jtu.keystr(k): tuple(v.spec) for k, v in jtu.tree_leaves_with_path(
        got, is_leaf=lambda x: isinstance(x, mesh.NamedSharding))}
    w = {jtu.keystr(k): tuple(v.spec) for k, v in jtu.tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))}
    assert g == w
    split = {k: v for k, v in g.items() if v}
    if "model" in shape:
        assert split == {"['embed']['kernel']": (None, "model"),
                         "['head']['kernel']": ("model", None)}
    else:
        assert split == {}


def _unsharded(params, batch, steps):
    model = polisher.trainable(params, device="cpu")
    step = polisher.make_train_step(torch.optim.Adam(model.parameters(), lr=1e-3))
    losses = [float(step(model, *(torch.from_numpy(a) for a in batch))) for _ in range(steps)]
    return convert.polisher_to_numpy(model), losses


@pytest.mark.parametrize("shape", SHAPES, ids=("data2", "data2-model2"))
def test_sharded_train_step_equals_the_unsharded_step(shape, batch):
    params = polisher.init_params(1, feature_dim=15)
    want_params, want_losses = _unsharded(params, batch, steps=2)
    m = mesh.make_mesh(shape, device="cpu")
    model = polisher.trainable(params, device="cpu")
    step_fn, place_params, place_batch = mesh.sharded_train_step(
        m, torch.optim.Adam(model.parameters(), lr=1e-3))
    placed = place_params(params)
    placed_batch = place_batch(*batch)
    n_slices = int(np.prod(list(shape.values())))
    assert len(placed["embed"]["kernel"].pieces) == n_slices
    if "model" in shape:
        assert placed["embed"]["kernel"].pieces[0].shape == (15, 48)
        assert placed["head"]["kernel"].pieces[0].shape == (96, 10)
    assert placed_batch[0].pieces[0].shape[0] == batch[0].shape[0] // 2
    losses = []
    for _ in range(2):
        placed, loss = step_fn(model, placed, *placed_batch)
        losses.append(float(loss))
    assert losses == want_losses
    got = jtu.tree_map(lambda p: p.gather().numpy(), placed,
                       is_leaf=lambda x: isinstance(x, mesh.GridPlaced))
    for (path, g), (_, w) in zip(jtu.tree_leaves_with_path(got),
                                 jtu.tree_leaves_with_path(want_params)):
        np.testing.assert_array_equal(g, w, err_msg=jtu.keystr(path))
    for gru in model.grus:
        for name, p in gru.named_parameters():
            if name.startswith("bias_hh"):
                assert torch.count_nonzero(p[: 2 * 96]) == 0


@pytest.mark.parametrize("shape", SHAPES, ids=("data2", "data2-model2"))
def test_placement_charges_jax_bytes(shape, batch):
    params = jax.tree_util.tree_map(np.asarray, jpolisher.init_params(0, feature_dim=15))
    got = []
    for side, reg_mod in ((mesh, tmetrics), (jmesh, jmetrics)):
        reg = reg_mod.arm()
        if side is mesh:
            m = mesh.make_mesh(shape, device="cpu")
            model = polisher.trainable(params, device="cpu")
            _, place_params, place_batch = mesh.sharded_train_step(
                m, torch.optim.Adam(model.parameters()))
        else:
            _, place_params, place_batch = jmesh.sharded_train_step(
                jmesh.make_mesh(shape), optax.adam(1e-3))
        place_params(params)
        after_params = reg.summary()["transfers"]["sites"]["transfer.h2d"]["h2d_bytes"]
        place_batch(*batch)
        total = reg.summary()["transfers"]["sites"]["transfer.h2d"]["h2d_bytes"]
        got.append((after_params, total - after_params))
        reg_mod.disarm()
    assert got[0] == got[1]
    param_bytes = sum(np.asarray(v).nbytes for v in jtu.tree_leaves(params))
    assert got[0][1] == (2 if "model" in shape else 1) * sum(a.nbytes for a in batch)
    assert got[0][0] > param_bytes
