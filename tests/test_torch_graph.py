"""The port's graph package against the JAX package's: the production
library graph (schedule, edges, placements, side sinks, skip closures,
crossing edges, graftcheck's report) under the config knobs, the builder's
validation on the JAX package's broken graphs (the same problems, word for
word), and the executor on small stub graphs (outputs, the telemetry graph
section, overlap, chaos, resume) with each package's own overlap pool,
timer, chaos registry and metrics registry."""

from __future__ import annotations

import threading
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import ont_tcrconsensus_tpu.graph as jgraph  # noqa: E402
from ont_tcrconsensus_tpu.graph import check as jcheck  # noqa: E402
from ont_tcrconsensus_tpu.graph import executor as jexecutor  # noqa: E402
from ont_tcrconsensus_tpu.graph import ir as jir  # noqa: E402
from ont_tcrconsensus_tpu.graph import pipeline as jpipeline  # noqa: E402
from ont_tcrconsensus_tpu.obs import metrics as jmetrics  # noqa: E402
from ont_tcrconsensus_tpu.pipeline import overlap as joverlap  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig  # noqa: E402
from ont_tcrconsensus_tpu.qc import timing as jtiming  # noqa: E402
from ont_tcrconsensus_tpu.robustness import faults as jfaults  # noqa: E402
import ont_tcrconsensus_tpu_torch.graph as tgraph  # noqa: E402
from ont_tcrconsensus_tpu_torch.graph import check as tcheck  # noqa: E402
from ont_tcrconsensus_tpu_torch.graph import executor as texecutor  # noqa: E402
from ont_tcrconsensus_tpu_torch.graph import ir as tir  # noqa: E402
from ont_tcrconsensus_tpu_torch.graph import pipeline as tpipeline  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import overlap as toverlap  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig  # noqa: E402
from ont_tcrconsensus_tpu_torch.qc import timing as ttiming  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import faults as tfaults  # noqa: E402

PORT = SimpleNamespace(ir=tir, check=tcheck, executor=texecutor, pipeline=tpipeline,
                       metrics=tmetrics, overlap=toverlap, timing=ttiming,
                       faults=tfaults, config=RunConfig)
JAX = SimpleNamespace(ir=jir, check=jcheck, executor=jexecutor, pipeline=jpipeline,
                      metrics=jmetrics, overlap=joverlap, timing=jtiming,
                      faults=jfaults, config=JConfig)
SIDES = (PORT, JAX)

# stub node names (outside the production vocabulary)
N_LOAD, N_COMPUTE, N_QC, N_EXTRA, N_FINISH = (
    "t-load", "t-compute", "t-qc", "t-extra", "t-finish")
N_RESUME, N_TAIL = "t-resume", "t-tail"


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for side in SIDES:
        side.faults.disarm()
        side.metrics.disarm()


def test_node_vocabulary_equals_jax():
    assert tgraph.GRAPH_NODES == jgraph.GRAPH_NODES
    assert tgraph.KNOWN_NODES is tgraph.GRAPH_NODES
    assert tir.PLACEMENTS == jir.PLACEMENTS
    assert tcheck.SEVERITIES == jcheck.SEVERITIES


# -- the production graph -----------------------------------------------------

KNOBS = [
    {},
    {"error_profile_sample": 0},
    {"write_intermediate_fastas": False},
    {"error_profile_sample": 0, "write_intermediate_fastas": False},
    {"max_read_length": 3072, "min_reads_per_cluster": 2},
]


def _shape(side, knobs):
    cfg = side.config.from_dict({"reference_file": "ref.fa", "fastq_pass_dir": "fq",
                                 **knobs})
    spec = side.pipeline.build_library_graph(cfg)
    nodes = [(n.name, n.inputs, n.outputs, n.checkpoint, n.resume_key,
              n.resume_provides, n.commit is not None, n.resume_probe is not None,
              n.resume_reload is not None, callable(n.units)) for n in spec.schedule]
    edges = {e.name: (e.placement, e.sharding, e.meta) for e in spec.edges.values()}
    resume = {n.name: (sorted(spec.skip_closure(n.name)), spec.crossing_edges(n.name))
              for n in spec.schedule if n.resume_key}
    report = side.check.analyze(spec, side.check.production_byte_model(cfg))
    return {
        "nodes": nodes, "edges": edges, "inputs": sorted(spec.inputs),
        "results": spec.results, "side_sinks": spec.side_sinks(),
        "describe": spec.describe(), "resume": resume,
        "ancestors": {n: sorted(spec.ancestors(n)) for n in spec.nodes},
        "summary": report.summary(), "report": report.to_dict(),
        "donation_plan": side.check.donation_plan(spec),
        "round_trips": side.check.round_trip_edges(spec),
        "reshard": side.check.reshard_sites(spec),
    }


@pytest.mark.parametrize("knobs", KNOBS, ids=range(len(KNOBS)))
def test_production_graph_equals_jax(knobs):
    got, want = _shape(PORT, knobs), _shape(JAX, knobs)
    assert got["summary"]["verdict"] == "clean"
    assert {n[0] for n in got["nodes"]} <= tgraph.GRAPH_NODES
    for key in want:
        if key == "reshard":
            assert [f.to_dict() for f in got[key]] == [f.to_dict() for f in want[key]]
        else:
            assert got[key] == want[key], key


def test_context_carries_the_jax_fields_and_the_device():
    import dataclasses

    port = {f.name for f in dataclasses.fields(tpipeline.LibraryContext)}
    jax = {f.name for f in dataclasses.fields(jpipeline.LibraryContext)}
    assert port == jax | {"device"}


# -- builder validation -------------------------------------------------------


def _diamond(ir, extra_sink=False):
    b = ir.GraphBuilder("t")
    b.input("src", "disk")
    b.edge("x", "hbm")
    b.edge("y", "host")
    b.edge("q", "host")
    b.edge("out", "host")
    b.add_node(N_LOAD, lambda ctx, i: {"x": i["src"] * 2}, inputs=("src",), outputs=("x",))
    b.add_node(N_COMPUTE, lambda ctx, i: {"y": i["x"] + 1}, inputs=("x",), outputs=("y",))
    b.add_node(N_QC, lambda ctx, i: {"q": ("qc", i["y"])}, inputs=("y",), outputs=("q",))
    if extra_sink:
        b.edge("q2", "host")
        b.add_node(N_EXTRA, lambda ctx, i: {"q2": ("extra", i["y"])}, inputs=("y",),
                   outputs=("q2",))
    b.add_node(N_FINISH, lambda ctx, i: {"out": i["y"] * 10}, inputs=("y",),
               outputs=("out",))
    b.result("out")
    return b


def _resume_chain(ir, placement, provides=("e2",), reload_fn="default"):
    b = ir.GraphBuilder("res")
    b.input("src", "disk")
    b.edge("e1", "host")
    b.edge("d", "disk")
    b.edge("e2", placement)
    b.edge("out", "host")
    b.edge("sq", "host")
    b.add_node(N_LOAD, lambda ctx, i: {"e1": 1}, inputs=("src",), outputs=("e1",))
    b.add_node(N_QC, lambda ctx, i: {"sq": 2}, inputs=("e1",), outputs=("sq",))
    rl = (lambda ctx: {"e2": 42}) if reload_fn == "default" else reload_fn
    b.add_node(N_RESUME, lambda ctx, i: {"d": "p", "e2": 42}, inputs=("e1",),
               outputs=("d", "e2"), resume_key="rk", resume_reload=rl,
               resume_provides=provides)
    b.add_node(N_TAIL, lambda ctx, i: {"out": i["e2"]}, inputs=("e2",), outputs=("out",))
    b.result("out")
    return b


def _bad_many(ir):
    b = ir.GraphBuilder("bad")
    b.input("src", "disk")
    b.edge("w", "vram")
    b.edge("lonely", "host")
    b.add_node(N_LOAD, None, inputs=("src", "ghost"), outputs=("w", "w2"))
    b.result("nope")
    return b


def _bad_cycle(ir):
    b = ir.GraphBuilder("cyc")
    b.edge("e1", "host")
    b.edge("e2", "host")
    b.add_node(N_LOAD, None, inputs=("e2",), outputs=("e1",))
    b.add_node(N_COMPUTE, None, inputs=("e1",), outputs=("e2",))
    b.result("e1")
    return b


def _bad_dup(ir):
    b = ir.GraphBuilder("dup")
    b.input("src", "disk")
    b.edge("y", "host")
    b.edge("y", "host")
    b.add_node(N_LOAD, None, inputs=("src",), outputs=("y",))
    b.add_node(N_LOAD, None, inputs=("src",), outputs=("y",))
    b.add_node(N_COMPUTE, None, inputs=("src",), outputs=("y",))
    b.result("y")
    return b


def _bad_clash(ir):
    b = ir.GraphBuilder("clash")
    b.input("src", "disk")
    b.edge(N_LOAD, "host")
    b.add_node(N_LOAD, None, inputs=("src",), outputs=(N_LOAD,))
    b.result(N_LOAD)
    return b


def _bad_sharding(ir):
    b = ir.GraphBuilder("sh")
    b.input("src", "disk")
    b.edge("x", "hbm", sharding="data")
    b.edge("y", "host", sharding="data")
    b.edge("z", "hbm", sharding="")
    b.edge("m", "disk", meta=True)
    b.add_node(N_LOAD, None, inputs=("src",), outputs=("x", "y", "z", "m"))
    b.result("x", "y", "z", "m")
    return b


def _bad_resume_disk(ir):
    b = ir.GraphBuilder("nodisk")
    b.input("src", "disk")
    b.edge("e1", "host")
    b.add_node(N_RESUME, None, inputs=("src",), outputs=("e1",), resume_key="rk")
    b.result("e1")
    return b


BROKEN = {
    "many": _bad_many,
    "cycle": _bad_cycle,
    "duplicates": _bad_dup,
    "edge-node-clash": _bad_clash,
    "sharding-and-meta": _bad_sharding,
    "resume-without-disk": _bad_resume_disk,
    "hbm-crossing-unprovided": lambda ir: _resume_chain(ir, "hbm", provides=()),
    "host-crossing-unprovided": lambda ir: _resume_chain(ir, "host", provides=()),
    "resume-without-reload": lambda ir: _resume_chain(ir, "host", reload_fn=None),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_builder_names_the_jax_problems(case):
    problems = []
    for side in SIDES:
        with pytest.raises(side.ir.GraphValidationError) as info:
            BROKEN[case](side.ir).build()
        assert str(info.value).startswith("invalid stage graph:")
        problems.append(info.value.problems)
    assert problems[0] == problems[1] and problems[0]


@pytest.mark.parametrize("build", [
    lambda ir: _diamond(ir), lambda ir: _diamond(ir, extra_sink=True),
    lambda ir: _resume_chain(ir, "host"), lambda ir: _resume_chain(ir, "hbm"),
], ids=["diamond", "two-sinks", "resume-host", "resume-hbm"])
def test_valid_stub_graphs_derive_as_in_jax(build):
    got = []
    for side in SIDES:
        spec = build(side.ir).build()
        got.append((spec.describe(), {n: sorted(spec.skip_closure(n)) for n in spec.nodes},
                    {n: spec.crossing_edges(n) for n in spec.nodes},
                    side.check.analyze(spec).to_dict()))
    assert got[0] == got[1]


# -- the executor on stub graphs -----------------------------------------------


def _ctx(side, **over):
    d = dict(cfg=SimpleNamespace(resume=False), timer=side.timing.StageTimer(), lay=None)
    d.update(over)
    return SimpleNamespace(**d)


def _graph_section(reg):
    g = reg.summary().get("graph", {})
    nodes = {k: {f: v for f, v in n.items() if f not in ("critical_s", "overlapped_s")}
             for k, n in g.get("nodes", {}).items()}
    return {"nodes": nodes, "edges": g.get("edges")}


def test_serial_run_and_its_telemetry_equal_jax():
    got = []
    for side in SIDES:
        reg = side.metrics.arm()
        out = side.executor.GraphExecutor(_diamond(side.ir).build(), _ctx(side)).run({"src": 3})
        got.append((out, _graph_section(reg), sorted(reg.summary()["stages"])))
        side.metrics.disarm()
    assert got[0] == got[1]
    assert got[0][0] == {"out": 70}


def test_side_sinks_overlap_by_declaration_and_commit_on_the_main_thread():
    got = []
    for side in SIDES:
        spec = _diamond(side.ir, extra_sink=True).build()
        threads, committed = {}, []
        for name in (N_QC, N_EXTRA):
            fn = spec.nodes[name].fn

            def spy(ctx, i, name=name, fn=fn):
                threads[name] = threading.get_ident()
                return fn(ctx, i)

            spec.nodes[name].fn = spy
        spec.nodes[N_EXTRA].commit = lambda ctx, o: committed.append(threading.get_ident())
        reg = side.metrics.arm()
        kw = {"device": None} if side is PORT else {}
        out = side.executor.GraphExecutor(
            spec, _ctx(side), side_exec=side.overlap.StageExecutor(2, **kw)).run({"src": 3})
        main = threading.get_ident()
        assert threads[N_QC] != main and threads[N_EXTRA] != main
        assert committed == [main]
        got.append((out, _graph_section(reg)))
        side.metrics.disarm()
    assert got[0] == got[1]


@pytest.mark.parametrize("site,kind,raises", [
    ("graph.node", "transient", "TransientChaosError"),
    ("graph.node", "error", "RuntimeError"),
    ("overlap.worker", "transient", None),
])
def test_chaos_at_nodes_and_workers_as_in_jax(site, kind, raises):
    got = []
    for side in SIDES:
        side.faults.arm([{"site": site, "kind": kind}])
        kw = {"device": None} if side is PORT else {}
        ex = side.executor.GraphExecutor(_diamond(side.ir).build(), _ctx(side),
                                         side_exec=side.overlap.StageExecutor(2, **kw))
        if raises:
            with pytest.raises(Exception) as info:
                ex.run({"src": 3})
            got.append((type(info.value).__name__, side.faults.fired(site)))
        else:
            got.append((ex.run({"src": 3}), side.faults.fired(site)))
        side.faults.disarm()
    assert got[0] == got[1]
    assert got[0][0] == (raises or {"out": 70}) and got[0][1] == 1


def test_resume_skips_the_closure_and_reloads_as_in_jax():
    class FakeLay:
        library = "t"

        def stage_done(self, key):
            return key == "rk"

        def verify_stage(self, key, mode):
            return True, None

    got = []
    for side in SIDES:
        ran = []
        spec = _resume_chain(side.ir, "host").build()
        for name in (N_LOAD, N_QC, N_RESUME, N_TAIL):
            fn = spec.nodes[name].fn

            def wrapped(ctx, i, name=name, fn=fn):
                ran.append(name)
                return fn(ctx, i)

            spec.nodes[name].fn = wrapped
        reg = side.metrics.arm()
        ctx = _ctx(side, cfg=SimpleNamespace(resume=True, verify_resume="fast"),
                   lay=FakeLay())
        out = side.executor.GraphExecutor(spec, ctx).run({"src": 0})
        got.append((out, ran, _graph_section(reg)))
        side.metrics.disarm()
    assert got[0] == got[1]
    assert got[0][:2] == ({"out": 42}, [N_TAIL])


def test_contract_errors_and_the_mesh_gate_as_in_jax():
    for side in SIDES:
        with pytest.raises(ValueError, match="missing inputs"):
            side.executor.GraphExecutor(_diamond(side.ir).build(), _ctx(side)).run({})
        b = side.ir.GraphBuilder("t")
        b.input("src", "disk")
        b.edge("y", "host")
        b.add_node(N_LOAD, lambda ctx, i: {"wrong": 1}, inputs=("src",), outputs=("y",))
        b.result("y")
        with pytest.raises(RuntimeError, match="returned edges"):
            side.executor.GraphExecutor(b.build(), _ctx(side)).run({"src": 0})
        b = side.ir.GraphBuilder("t")
        b.input("src", "disk")
        b.edge("ina", "hbm", sharding="data")
        b.edge("outa", "hbm", sharding="model")
        b.edge("res", "host")
        b.add_node(N_LOAD, lambda ctx, i: {"ina": i["src"]}, inputs=("src",),
                   outputs=("ina",))
        b.add_node(N_COMPUTE, lambda ctx, i: {"outa": i["ina"]}, inputs=("ina",),
                   outputs=("outa",))
        b.add_node(N_FINISH, lambda ctx, i: {"res": i["outa"]}, inputs=("outa",),
                   outputs=("res",))
        b.result("res")
        spec = b.build()
        ctx = _ctx(side, engine=SimpleNamespace(mesh=object()))
        with pytest.raises(RuntimeError, match="cannot run sharded"):
            side.executor.GraphExecutor(spec, ctx).run({"src": 1})
        assert side.executor.GraphExecutor(spec, _ctx(side)).run({"src": 5}) == {"res": 5}
    # a consistent graph under a mesh runs, with each node's sharding plan
    # published on the context as in JAX
    got = []
    for side in SIDES:
        seen = []
        spec = _diamond(side.ir).build()
        spec.nodes[N_FINISH].fn = lambda ctx, i, seen=seen: (
            seen.append(ctx.node_shardings) or {"out": i["y"] * 10})
        ctx = _ctx(side, engine=SimpleNamespace(mesh=object()))
        got.append((side.executor.GraphExecutor(spec, ctx).run({"src": 1}), seen))
    assert got[0] == got[1] == ({"out": 30}, [None])


def test_a_lost_device_without_a_remesh_hook_propagates():
    for side in SIDES:
        spec = _diamond(side.ir).build()

        def dying(ctx, i, side=side):
            raise side.faults.DeviceLostChaosError("DEVICE_LOST: no survivors")

        spec.nodes[N_LOAD].fn = dying
        with pytest.raises(side.faults.DeviceLostChaosError):
            side.executor.GraphExecutor(spec, _ctx(side)).run({"src": 3})
