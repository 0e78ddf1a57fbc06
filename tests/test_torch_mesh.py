"""The port's data mesh against the JAX package's, on eight CPU slices.

The JAX package's tests run its mesh on eight virtual XLA CPU devices
(``tests/conftest.py``); the port's counterpart installs eight CPU slices
with ``install_slice_devices``. Covered: ``make_mesh`` (default, 2-D,
overflow, the CPU default and the platform check), ``shard_batch`` (its
placement, its transfer charge and the slice gauges), ``degrade_mesh``
(the power-of-two ladder with its gauges, the ``model`` axis, the degrade
hook), ``degraded_budget``, ``node_sharding_plan`` on both packages'
library graphs, the runner (slice order, lockstep, launches by slice),
the executor's degraded-mesh loop, and the sharded functions fed the same
seeded numpy inputs as the JAX package's sharded ones: the fused and
targeted assign passes field by field, the pileup, the consensus
(``data=8`` and the non-power-of-two ``data=6``) and the dovetail
distances. Integer outputs are equal; float outputs as in
``test_torch_assign.py`` (rtol 1e-6, NaNs where JAX has them)."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ont_tcrconsensus_tpu.cluster import regions as jregions  # noqa: E402
from ont_tcrconsensus_tpu.graph import executor as jexecutor  # noqa: E402
from ont_tcrconsensus_tpu.graph import ir as jir  # noqa: E402
from ont_tcrconsensus_tpu.graph import pipeline as jpipeline  # noqa: E402
from ont_tcrconsensus_tpu.io import simulator as jsim  # noqa: E402
from ont_tcrconsensus_tpu.obs import metrics as jmetrics  # noqa: E402
from ont_tcrconsensus_tpu.ops import consensus as jconsensus  # noqa: E402
from ont_tcrconsensus_tpu.ops import edit_distance as jedit  # noqa: E402
from ont_tcrconsensus_tpu.ops import pileup as jpileup  # noqa: E402
from ont_tcrconsensus_tpu.parallel import budget as jbudget  # noqa: E402
from ont_tcrconsensus_tpu.parallel import mesh as jmesh  # noqa: E402
from ont_tcrconsensus_tpu.pipeline import assign as jassign  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig  # noqa: E402
from ont_tcrconsensus_tpu.qc import timing as jtiming  # noqa: E402
from ont_tcrconsensus_tpu.robustness import faults as jfaults  # noqa: E402
from ont_tcrconsensus_tpu.robustness import retry as jretry  # noqa: E402
from ont_tcrconsensus_tpu_torch import convert  # noqa: E402
from ont_tcrconsensus_tpu_torch.graph import executor as texecutor  # noqa: E402
from ont_tcrconsensus_tpu_torch.graph import ir as tir  # noqa: E402
from ont_tcrconsensus_tpu_torch.graph import pipeline as tpipeline  # noqa: E402
from ont_tcrconsensus_tpu_torch.io import bucketing, fastx  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import consensus, edit_distance, pileup  # noqa: E402
from ont_tcrconsensus_tpu_torch.parallel import budget, mesh  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import assign  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig  # noqa: E402
from ont_tcrconsensus_tpu_torch.qc import timing as ttiming  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import faults as tfaults  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import retry as tretry  # noqa: E402

# stub node names (outside the production vocabulary)
N_LOAD, N_FINISH = "t-load", "t-finish"
UMI_FWD = "TTTVVTTVVVVTTVVVVTTVVVVTTVVVVTTT"
UMI_REV = "AAABBBBAABBBBAABBBBAABBBBAABBAAA"
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _eight_cpu_slices():
    """The port's counterpart of the JAX tests' eight virtual devices."""
    assert len(jax.devices()) == 8
    mesh.install_slice_devices(CPU8)
    yield
    mesh.install_slice_devices(None)
    mesh.install_degrade_hook(None)
    for reg in (tmetrics, jmetrics):
        reg.disarm()
    for f in (tfaults, jfaults):
        f.disarm()


def _labels(m) -> list[str]:
    return [f"{d.platform}:{d.id}" for d in m.devices.flat]


# -- make_mesh ---------------------------------------------------------------


def test_make_mesh_default_puts_every_slice_on_the_data_axis():
    m, jm = mesh.make_mesh(), jmesh.make_mesh()
    assert m.axis_names == jm.axis_names == ("data",)
    assert m.devices.size == jm.devices.size == 8
    assert _labels(m) == _labels(jm) == [f"cpu:{i}" for i in range(8)]
    assert mesh.mesh_data_size(m) == jmesh.mesh_data_size(jm) == 8


def test_make_mesh_2d_and_overflow_as_in_jax():
    m, jm = mesh.make_mesh({"data": 4, "model": 2}), jmesh.make_mesh({"data": 4, "model": 2})
    assert m.devices.shape == jm.devices.shape == (4, 2)
    assert _labels(m) == _labels(jm)
    # one slice per data index: the first slice of each data row
    assert [s.label for s in m.data_slices()] == ["cpu:0", "cpu:2", "cpu:4", "cpu:6"]
    msgs = []
    for side in (mesh, jmesh):
        with pytest.raises(ValueError, match="devices") as exc:
            side.make_mesh({"data": 64})
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] == "mesh {'data': 64} needs 64 devices, have 8"


def test_the_default_slices_follow_the_run_device(monkeypatch):
    mesh.install_slice_devices(None)
    m = mesh.make_mesh(device="cpu")
    assert [s.label for s in m.devices.flat] == ["cpu:0"]
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        mesh.make_mesh({"data": 2}, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    # installed or explicit slices never mix the CPU with a card
    with pytest.raises(ValueError, match="platform"):
        mesh.make_mesh(devices=["cuda:0", "cuda:0"], device="cpu")
    m = mesh.make_mesh({"data": 2}, devices=["cpu", "cpu"], device="cpu")
    assert [s.label for s in m.devices.flat] == ["cpu:0", "cpu:1"]


# -- placement, transfer charge, gauges ------------------------------------------


def test_shard_batch_places_the_leading_axis():
    m, jm = mesh.make_mesh({"data": 8}), jmesh.make_mesh({"data": 8})
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    sx, jsx = mesh.shard_batch(m, x), jmesh.shard_batch(jm, x)
    assert tuple(sx.sharding.spec) == tuple(jsx.sharding.spec) == ("data", None)
    assert [tuple(s.shape) for s in sx.shards] == [(1, 16)] * 8
    np.testing.assert_array_equal(sx.gather().numpy(), np.asarray(jsx))


def test_shard_batch_charges_each_slice_and_marks_it_busy():
    x = np.zeros((16, 32), np.float32)
    y = np.zeros((16,), np.int32)
    got = []
    for side, reg_mod in ((mesh, tmetrics), (jmesh, jmetrics)):
        reg = reg_mod.arm()
        m = side.make_mesh({"data": 8})
        sx, sy = side.shard_batch(m, x, y)
        assert side.materialized_shard_bytes(sx) == x.nbytes
        s = reg.summary()
        got.append((s["transfers"]["sites"]["transfer.h2d"]["h2d_bytes"],
                    s["counters"]["transfer.h2d"], s["mesh_slice_busy"],
                    s["gauges"]["mesh.slice_busy"]))
        reg_mod.disarm()
    assert got[0] == got[1] == (x.nbytes + y.nbytes, x.nbytes + y.nbytes,
                                {f"cpu:{i}": 1.0 for i in range(8)}, 8.0)


def test_a_replica_costs_one_copy_per_device():
    """The JAX package charges one copy per slice (each is its own
    device); the port's slices of one device share one copy."""
    a = np.zeros((4, 4), np.float32)
    m = mesh.make_mesh({"data": 8})
    placed = mesh.replicate(m, a)
    assert len({id(s) for s in placed.shards}) == 1
    assert mesh.materialized_shard_bytes(placed) == a.nbytes
    jm = jmesh.make_mesh({"data": 8})
    assert jmesh.materialized_shard_bytes(jax.device_put(a, jmesh.replicated(jm))) == 8 * a.nbytes
    assert mesh.materialized_shard_bytes(a) == jmesh.materialized_shard_bytes(a) == a.nbytes
    two = mesh.make_mesh({"data": 2}, devices=["cpu", "meta"])
    assert mesh.materialized_shard_bytes(mesh.replicate(two, a)) == 2 * a.nbytes


# -- degradation ---------------------------------------------------------------


def test_degrade_mesh_power_of_two_ladder_and_gauges():
    got = []
    for side, reg_mod in ((mesh, tmetrics), (jmesh, jmetrics)):
        reg = reg_mod.arm()
        m = side.make_mesh({"data": 8})
        side.mark_mesh_slices(m)
        sizes = []
        while m is not None:
            m = side.degrade_mesh(m)
            if m is not None:
                sizes.append(side.mesh_data_size(m))
        s = reg.summary()
        got.append((sizes, s["mesh_slice_busy"], s["gauges"]["mesh.slice_busy"]))
        reg_mod.disarm()
    assert got[0] == got[1]
    assert got[0][0] == [4, 2, 1]
    assert got[0][1] == {"cpu:0": 1.0, **{f"cpu:{i}": 0.0 for i in range(1, 8)}}


def test_degrade_mesh_keeps_the_model_axis():
    m, jm = mesh.make_mesh({"data": 4, "model": 2}), jmesh.make_mesh({"data": 4, "model": 2})
    d, jd = mesh.degrade_mesh(m), jmesh.degrade_mesh(jm)
    assert d.shape == dict(zip(jd.axis_names, jd.devices.shape)) == {"data": 2, "model": 2}
    assert _labels(d) == _labels(jd) == _labels(m)[:4]


def test_degrade_hook_gets_the_lost_slices_and_its_errors_are_swallowed():
    lost = []
    mesh.install_degrade_hook(lambda slices: lost.append([s.label for s in slices]))
    d = mesh.degrade_mesh(mesh.make_mesh({"data": 8}))
    assert lost == [[f"cpu:{i}" for i in range(4, 8)]]

    def broken(_):
        raise RuntimeError("bookkeeping failed")

    mesh.install_degrade_hook(broken)
    assert mesh.mesh_data_size(mesh.degrade_mesh(d)) == 2
    assert mesh.degrade_mesh(mesh.make_mesh({"data": 1})) is None


@pytest.mark.parametrize("surv,total", [(1, 2), (2, 2), (4, 2), (3, 8), (0, 4)])
def test_degraded_budget_equals_jax(surv, total):
    b, jb = budget.BudgetModel(hbm_gb=16.0), jbudget.BudgetModel(hbm_gb=16.0)
    d, jd = budget.degraded_budget(b, surv, total), jbudget.degraded_budget(jb, surv, total)
    assert d.hbm_gb == jd.hbm_gb
    assert (d is b) == (jd is jb) == (surv >= total)
    assert d.read_batch(1024) == jd.read_batch(1024)
    assert d.cluster_batch(8, 1024) == jd.cluster_batch(8, 1024)


@pytest.mark.parametrize("knobs", [{}, {"error_profile_sample": 0}, {"executor": "graph"}])
def test_node_sharding_plan_equals_jax(knobs):
    base = {"reference_file": "r.fa", "fastq_pass_dir": "fq", **knobs}
    spec = tpipeline.build_library_graph(RunConfig.from_dict(base))
    jspec = jpipeline.build_library_graph(JConfig.from_dict(base))
    m, jm = mesh.make_mesh({"data": 2}), jmesh.make_mesh({"data": 2})
    plan = mesh.node_sharding_plan(spec, m)
    assert plan, "the library graph declares no sharded edge"
    assert plan == jmesh.node_sharding_plan(jspec, jm) == mesh.node_sharding_plan(jspec, m)
    for maps in plan.values():
        for axis in list(maps["in"].values()) + list(maps["out"].values()):
            sh, jsh = mesh.axis_sharding(m, axis, 2), jmesh.axis_sharding(jm, axis, 2)
            assert tuple(sh.spec) == tuple(jsh.spec) == (axis, None)


# -- the runner ----------------------------------------------------------------


def test_the_runner_splits_replicates_and_concatenates_in_slice_order():
    m = mesh.make_mesh({"data": 4})
    x = torch.arange(8).reshape(8, 1)
    seen = []

    def f(rows, whole, scalar):
        seen.append((mesh.current_slice_label(), rows[:, 0].tolist(), whole.shape[0], scalar))
        return {"y": rows * 10 + scalar, "w": whole}

    out = mesh.shard_map_compat(f, m, in_specs=(mesh.P("data", None), mesh.P(), mesh.P()),
                                out_specs={"y": mesh.P("data", None), "w": mesh.P()})(x, x, 1)
    assert seen == [(f"cpu:{i}", [2 * i, 2 * i + 1], 8, 1) for i in range(4)]
    assert out["y"][:, 0].tolist() == [10 * i + 1 for i in range(8)]
    assert out["w"] is x
    assert mesh.current_slice_label() is None
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_map_compat(f, m, in_specs=(mesh.P("data"), mesh.P(), mesh.P()),
                              out_specs={"y": mesh.P("data"), "w": mesh.P()})(x[:6], x, 1)


def test_lockstep_advances_every_slice_one_step_at_a_time():
    m = mesh.make_mesh({"data": 3})
    order = []

    def steps(rows):
        for t in range(2 + int(rows[0])):
            order.append((int(rows[0]), t))
            yield
        return rows + 1

    out = mesh.shard_map_compat(steps, m, in_specs=(mesh.P("data"),),
                                out_specs=mesh.P("data"))(torch.tensor([0, 1, 2]))
    assert out.tolist() == [1, 2, 3]
    assert order == [(0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (2, 1), (1, 2), (2, 2), (2, 3)]


def test_launches_count_by_slice_inside_sharded_calls():
    by_slice: dict = {}

    def f(rows):
        mesh.count_slice_launch(by_slice)
        yield
        mesh.count_slice_launch(by_slice)
        return rows

    mesh.shard_map_compat(f, mesh.make_mesh({"data": 2}), in_specs=(mesh.P("data"),),
                          out_specs=mesh.P("data"))(torch.zeros(4))
    mesh.count_slice_launch(by_slice)  # outside a sharded call: not counted
    assert by_slice == {"cpu:0": 2, "cpu:1": 2}


def test_the_degraded_mesh_loop_reruns_the_node_as_in_jax():
    got = []
    for ir, executor, reg_mod, timing, retry in (
            (tir, texecutor, tmetrics, ttiming, tretry),
            (jir, jexecutor, jmetrics, jtiming, jretry)):
        reg = reg_mod.arm()
        retry.recorder().reset()
        b = ir.GraphBuilder("t")
        b.input("src", "disk")
        b.edge("x", "hbm", sharding="data")
        b.edge("out", "host")
        calls = []

        def load(ctx, i, calls=calls, faults=(tfaults if ir is tir else jfaults)):
            calls.append(ctx.node_shardings)
            if len(calls) == 1:
                raise faults.DeviceLostChaosError("DEVICE_LOST: slice 1")
            return {"x": i["src"] * 2}

        b.add_node(N_LOAD, load, inputs=("src",), outputs=("x",))
        b.add_node(N_FINISH, lambda ctx, i: {"out": i["x"] + 1}, inputs=("x",),
                   outputs=("out",))
        b.result("out")
        remeshed = []
        ctx = SimpleNamespace(cfg=SimpleNamespace(resume=False), timer=timing.StageTimer(),
                              lay=None, engine=SimpleNamespace(mesh=object()),
                              remesh=lambda node, exc: remeshed.append(node)
                              or {"data_from": 2, "data_to": 1})
        out = executor.GraphExecutor(b.build(), ctx).run({"src": 4})
        events = [{k: e[k] for k in ("site", "classification", "outcome", "detail")}
                  for e in retry.recorder().events]
        s = reg.summary()
        got.append((out, calls, remeshed, events, s["counters"].get("mesh.degraded"),
                    s.get("mesh_degraded_by_site")))
        reg_mod.disarm()
    assert got[0] == got[1]
    assert got[0][0] == {"out": 9}
    assert got[0][1] == [{"in": {}, "out": {"x": "data"}}] * 2
    assert got[0][3] == [{"site": "mesh.degraded", "classification": "device_lost",
                          "outcome": "degraded",
                          "detail": {"node": N_LOAD, "data_from": 2, "data_to": 1}}]


# -- the sharded functions against the JAX package's ---------------------------------


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    lib = jsim.simulate_library(
        seed=19, num_regions=3, molecules_per_region=(2, 3), reads_per_molecule=(5, 8),
        sub_rate=0.01, ins_rate=0.004, del_rate=0.004, region_len=(650, 800),
        with_adapters=True, num_similar_pairs=1, similar_divergence=0.01,
        num_negative_controls=1,
    )
    homology = jregions.self_homology_map(lib.reference, 0.93)
    jpanel = jassign.ReferencePanel.build(lib.reference, homology.region_cluster)
    tpanel = convert.panel_from_numpy(
        jpanel.codes, jpanel.lens, jpanel.profiles, jpanel.names, jpanel.region_cluster,
        device="cpu", seqs=jpanel.seqs,
    )
    primers = JConfig(reference_file="r", fastq_pass_dir="f").primer_sequences()
    recs = [fastx.FastxRecord(h.split()[0], " ".join(h.split()[1:]), s, q)
            for h, s, q in lib.reads]
    batches = list(bucketing.batch_reads(iter(recs[:64]), batch_size=64, widths=(1024,)))
    return jpanel, tpanel, primers, batches


def _assert_out_equal(jo: dict, to: dict):
    assert set(jo) == set(to)
    for k in jo:
        x, y = np.asarray(jo[k]), np.asarray(to[k])
        if np.issubdtype(x.dtype, np.floating):
            np.testing.assert_allclose(y, x, rtol=1e-6, equal_nan=True, err_msg=k)
        else:
            np.testing.assert_array_equal(y, x, err_msg=k)


def _engines(lane, n):
    jpanel, tpanel, primers, _ = lane
    je = jassign.AssignEngine(jpanel, UMI_FWD, UMI_REV, primers=primers,
                              mesh=jmesh.make_mesh({"data": n}))
    te = assign.AssignEngine(tpanel, UMI_FWD, UMI_REV, primers=primers, device="cpu",
                             mesh=mesh.make_mesh({"data": n}))
    return je, te


@pytest.mark.parametrize("n,overlap_frac", [(2, 0.95), (8, 0.95), (2, None)])
def test_sharded_fused_pass_equals_jax(lane, n, overlap_frac):
    """Each slice runs the fast path's subset pick on its own rows, as each
    JAX shard does, so the split result is JAX's split one."""
    je, te = _engines(lane, n)
    for batch in lane[3]:
        jo = je.run_batch(batch, 0.07, 500, overlap_frac=overlap_frac)
        to = te.run_batch(batch, 0.07, 500, overlap_frac=overlap_frac)
        _assert_out_equal(jo, to)
        assert to["sw_done"].any()


def test_sharded_targeted_pass_equals_jax_and_set_mesh_drops_the_replicas(lane):
    jpanel = lane[0]
    je, te = _engines(lane, 4)
    batch = lane[3][0]
    rng = np.random.default_rng(3)
    cand = np.full((len(batch.ids), 2), -1, np.int32)
    for row in range(len(batch.ids)):
        k = int(rng.integers(1, 3))
        cand[row, :k] = rng.choice(len(jpanel.names), size=k, replace=False)
    jo = jax.device_get(je.run_batch_targeted_async(batch, cand, 1))
    _assert_out_equal(jo, te.run_batch_targeted(batch, cand, 1))
    assert set(te._sharded_cache) == {"targeted"}
    degraded = mesh.degrade_mesh(te.mesh)
    te.set_mesh(degraded)
    je.set_mesh(jmesh.degrade_mesh(je.mesh))
    assert te._sharded_cache == {} and te.mesh is degraded
    jo = jax.device_get(je.run_batch_targeted_async(batch, cand, 1))
    _assert_out_equal(jo, te.run_batch_targeted(batch, cand, 1))


def test_sharded_pileup_equals_jax():
    rng = np.random.default_rng(1)
    C, S, W = 8, 4, 256
    sub = rng.integers(0, 4, (C, S, W)).astype(np.uint8)
    lens = rng.integers(W // 2, W, (C, S)).astype(np.int32)
    drafts = sub[:, 0, :].copy()
    dlens = lens[:, 0].copy()
    want = jpileup.pileup_columns_batch_auto(
        sub, lens, jnp.asarray(drafts), jnp.asarray(dlens), band_width=64, out_len=W,
        mesh=jmesh.make_mesh({"data": 8}),
    )
    t = [torch.from_numpy(a) for a in (sub, lens, drafts, dlens)]
    got = pileup.pileup_columns_batch_auto(*t, band_width=64, out_len=W,
                                           mesh=mesh.make_mesh({"data": 8}))
    plain = pileup.pileup_columns_batch_auto(*t, band_width=64, out_len=W)
    for w, g, p in zip(want, got, plain):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), p.numpy())


def _noisy_clusters(seed, C, S, W, template_len):
    rng = np.random.default_rng(seed)
    sub = np.zeros((C, S, W), np.uint8)
    lens = np.zeros((C, S), np.int32)
    for c in range(C):
        template = rng.integers(0, 4, template_len).astype(np.uint8)
        for s in range(S):
            out = []
            for b in template:
                r = rng.random()
                if r < 0.01:
                    continue
                if r < 0.02:
                    out.append(rng.integers(0, 4))
                out.append(int(b) if rng.random() > 0.02 else int(rng.integers(0, 4)))
            mut = np.array(out, np.uint8)
            sub[c, s, : len(mut)] = mut
            lens[c, s] = len(mut)
    return sub, lens


@pytest.mark.parametrize("n,C,S,seed,tlen", [(8, 8, 6, 2, 180), (6, 6, 4, 5, 150),
                                            (4, 6, 4, 7, 150)])
def test_sharded_consensus_equals_jax(n, C, S, seed, tlen):
    """``data=6`` is JAX's non-power-of-two case (no compaction, every
    round over all C); C=6 under ``data=4`` drops the mesh at the entry
    guard. The kept final pileup equals JAX's too."""
    sub, lens = _noisy_clusters(seed, C, S, 256, tlen)
    jm = jmesh.make_mesh({"data": n}, devices=jax.devices()[:n])
    jd, jl, jpile = jconsensus.consensus_clusters_batch(sub, lens, mesh=jm,
                                                        keep_final_pileup=True)
    m = mesh.make_mesh({"data": n})
    d, dl, pile = consensus.consensus_clusters_batch(sub, lens, mesh=m, device="cpu",
                                                     keep_final_pileup=True)
    np.testing.assert_array_equal(dl, np.asarray(jl))
    np.testing.assert_array_equal(d, np.asarray(jd))
    assert (pile is None) == (jpile is None)
    if pile is not None:
        for g, w in zip(pile, jpile):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    d0, l0 = consensus.consensus_clusters_batch(sub, lens, device="cpu")
    np.testing.assert_array_equal(d, d0)
    np.testing.assert_array_equal(dl, l0)


def test_sharded_dovetail_distances_equal_jax():
    rng = np.random.default_rng(4)
    B, L = 64, 72
    a = rng.integers(0, 4, (B, L)).astype(np.uint8)
    b = a.copy()
    b[:, ::9] = rng.integers(0, 4, (B, (L + 8) // 9))
    al = rng.integers(40, L + 1, B).astype(np.int32)
    bl = rng.integers(40, L + 1, B).astype(np.int32)
    jm, m = jmesh.make_mesh({"data": 8}), mesh.make_mesh({"data": 8})
    t = [torch.from_numpy(x) for x in (a, al, b, bl)]
    for k_end in (8, 16):
        want = np.asarray(jedit.pairwise_dovetail_auto(a, al, b, bl, k_end=k_end, mesh=jm))
        got = edit_distance.pairwise_dovetail_auto(*t, k_end=k_end, mesh=m)
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jedit.many_vs_many_dovetail_auto(a[:16], al[:16], b[:24], bl[:24],
                                                       mesh=jm))
    got = edit_distance.many_vs_many_dovetail_auto(t[0][:16], t[1][:16], t[2][:24],
                                                   t[3][:24], mesh=m)
    np.testing.assert_array_equal(got.numpy(), want)
