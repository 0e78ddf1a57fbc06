"""The PyTorch port end to end against the JAX package: the counts CSV and
the merged consensus FASTA must be byte-identical, and the counts equal the
simulator's truth. Two lanes: the JAX package's e2e lane (seed 11, four
pre-trimmed regions of 700-850 nt, iid errors) and an untrimmed one (seed
23, adapters and primers, the systematic ONT error model, a near-duplicate
pair and a negative control). Each lane runs under ``rnn`` polish (the
default: no ``polish_method`` key, so the bi-GRU polisher with the bundled
weights) and under ``poa``, at read batch 64. A third lane (seed 29, 2-4
reads a molecule, clusters of 2 subreads kept) runs ``rnn`` only: there the
polisher, its depth-2 pass on qualities and strands included, changes the
consensus, so its counts are the JAX package's, not the truth. The port
runs through its CLI with ``--cpu``; without that flag it asks for the CUDA
card. On every lane the port writes every file the JAX package writes under
``nano_tcr/`` (the QC logs and CSVs, both error profiles, the
self-homology logs, ``robustness_report.json``, ...), byte for byte, but
for the files :data:`NOT_BYTE_COMPARED` names, and nothing else. The
observation files of timings (``telemetry.json``, ``history.jsonl``, and
``logs/trace.json`` where written) are compared by schema and by names:
the stage names, the dispatch sites with their dispatch and get counts,
the graph executor's sections (graftcheck's verdict, the donation
verdicts, the per-node memory estimate), and the history entry's config
fingerprint. Both packages run their default executor, the graph;
``test_torch_e2e_imperative.py`` runs these tests on the clean lane under
``poa`` with both under ``executor: "imperative"``."""

import json

import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu.io import fastx as jfastx  # noqa: E402
from ont_tcrconsensus_tpu.io import simulator as jsim  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.run import run_with_config as jax_run  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import cli  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import run as trun  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig  # noqa: E402

ARTIFACTS = ("counts/umi_consensus_counts.csv", "fasta/merged_consensus.fasta")
# files of timings under nano_tcr/, compared by schema and names, not bytes
BY_SCHEMA = {
    "telemetry.json": "the run's telemetry roll-up: seconds, bytes and counts",
    "history.jsonl": "the run ledger entry: timings, commit and time of day",
    "logs/trace.json": "the timeline (written only under telemetry full)",
}
# files under nano_tcr/ of the JAX run that are not compared byte for byte
NOT_BYTE_COMPARED = {
    **BY_SCHEMA,
    "barcode01/stage_manifest.json": "completion timestamps",
    "barcode01/logs/stage_timing.tsv": "seconds: its stage column is compared instead",
}
TIMING = "barcode01/logs/stage_timing.tsv"
# maps keyed by names (stages, sites, labels, edges): their keys are data,
# compared by the tests that name them, and their values by schema
NAME_MAPS = {"stages", "dispatch", "dispatch_by_stage", "compile.by_stage", "counters",
             "gauges", "histograms", "transfers.sites", "transfers.edges",
             "robustness_events"}


def _tree(root) -> dict[str, bytes]:
    nano = root / "fastq_pass" / "nano_tcr"
    return {p.relative_to(nano).as_posix(): p.read_bytes()
            for p in sorted(nano.rglob("*")) if p.is_file()}


def _lane_dir(root, lib, method, lane, executor="graph"):
    root.mkdir()
    jfastx.write_fasta(root / "reference.fa", lib.reference.items())
    (root / "fastq_pass" / "barcode01").mkdir(parents=True)
    jfastx.write_fastq(root / "fastq_pass" / "barcode01" / "barcode01.fastq.gz", lib.reads)
    return {
        "reference_file": str(root / "reference.fa"),
        "fastq_pass_dir": str(root / "fastq_pass"),
        "minimal_length": 600,
        "min_reads_per_cluster": 2 if lane == "lowdepth" else 4,
        "read_batch_size": 64,
        "delete_tmp_files": False,
        **({} if method == "rnn" else {"polish_method": method}),
        **({} if executor == "graph" else {"executor": executor}),
    }


LANES = {
    "clean": dict(seed=11, num_regions=4, molecules_per_region=(2, 3),
                  reads_per_molecule=(5, 8), sub_rate=0.006, ins_rate=0.003,
                  del_rate=0.003, region_len=(700, 850)),
    "untrimmed": dict(seed=23, num_regions=3, molecules_per_region=(2, 3),
                      reads_per_molecule=(5, 8), region_len=(700, 850),
                      with_adapters=True, num_similar_pairs=1, similar_divergence=0.01,
                      num_negative_controls=1),
    "lowdepth": dict(seed=29, num_regions=3, molecules_per_region=(2, 3),
                     reads_per_molecule=(2, 5), region_len=(700, 850), with_adapters=True,
                     num_similar_pairs=1, similar_divergence=0.01, num_negative_controls=1),
}
RUNS = [("clean", "poa"), ("clean", "rnn"), ("untrimmed", "poa"), ("untrimmed", "rnn"),
        ("lowdepth", "rnn")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU passes are loops of small launches: one intra-op
    thread runs them as fast as eight, and leaves the cores to the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=RUNS, ids="-".join)
def runs(request, tmp_path_factory):
    return lane_runs(request.param, tmp_path_factory)


def lane_runs(param, tmp_path_factory):
    """Run one lane through both packages: (lane, polish method[,
    executor]), the graph executor by default."""
    lane, method, *rest = param
    executor = rest[0] if rest else "graph"
    tmp = tmp_path_factory.mktemp(f"torch_e2e_{lane}_{method}_{executor}")
    kw = dict(LANES[lane])
    if kw.get("with_adapters"):
        kw["error_model"] = jsim.OntErrorModel()
    lib = jsim.simulate_library(**kw)
    port_cfg = _lane_dir(tmp / "port", lib, method, lane, executor)
    cfg_path = tmp / "port_config.json"
    cfg_path.write_text(json.dumps(port_cfg))
    assert cli.main([str(cfg_path), "--cpu"]) == 0
    jax_results = jax_run(JConfig.from_dict(_lane_dir(tmp / "jax", lib, method, lane,
                                                      executor)))
    sides = ["port", "jax"]
    if lane == "lowdepth":  # the vote consensus alone, for what the polisher changed
        trun.run_with_config(RunConfig.from_dict(_lane_dir(tmp / "vote", lib, "poa", lane)),
                             device="cpu")
        sides.append("vote")
    trees = {side: _tree(tmp / side) for side in sides}
    out = {side: {rel: trees[side][f"barcode01/{rel}"] for rel in ARTIFACTS} for side in sides}
    return lib, out, jax_results, lane, trees, executor


def _config(tmp_path, **knobs):
    """A run config whose checks fail before any file is read."""
    return RunConfig.from_dict({
        "reference_file": str(tmp_path / "reference.fa"),
        "fastq_pass_dir": str(tmp_path), "polish_method": "poa", **knobs,
    })


@pytest.mark.parametrize("rel", ARTIFACTS)
def test_artifacts_byte_identical_to_jax(runs, rel):
    _, out, *_ = runs
    assert out["port"][rel] == out["jax"][rel]


def test_every_jax_artifact_is_written_byte_identical(runs):
    *_, trees, _ = runs
    port, jax = trees["port"], trees["jax"]
    compared = sorted(set(jax) - set(NOT_BYTE_COMPARED))
    assert "robustness_report.json" in compared
    assert "barcode01/logs/merged_consensus_align_error_profile.log" in compared
    assert [rel for rel in compared if rel not in port] == []
    assert [rel for rel in compared if port[rel] != jax[rel]] == []


def test_the_port_writes_nothing_the_jax_run_does_not(runs):
    *_, trees, _ = runs
    assert sorted(set(trees["port"]) - set(trees["jax"])) == []


def _schema(value, path=""):
    """The shape of a JSON value: key sets, element types, numbers as one
    type; a name map becomes the one shape of its values."""
    if isinstance(value, dict):
        if path in NAME_MAPS:
            shapes = {json.dumps(_schema(v, f"{path}.*"), sort_keys=True)
                      for v in value.values()}
            assert len(shapes) <= 1, (path, shapes)
            return {"*": json.loads(shapes.pop())} if shapes else {}
        return {k: _schema(v, f"{path}.{k}" if path else k) for k, v in value.items()}
    if isinstance(value, list):
        return ["list"]
    if isinstance(value, bool) or value is None or isinstance(value, str):
        return type(value).__name__
    assert isinstance(value, (int, float)), (path, value)
    return "number"


def _assert_same_schema(port, jax, path=""):
    if isinstance(jax, dict) and isinstance(port, dict):
        if "*" in jax or "*" in port:  # a name map: one shape, or no entry
            if "*" in jax and "*" in port:
                _assert_same_schema(port["*"], jax["*"], f"{path}.*")
            return
        pk, jk = set(port), set(jax)
        assert pk == jk, (path, sorted(pk ^ jk))
        for key in pk:
            _assert_same_schema(port[key], jax[key], f"{path}.{key}" if path else key)
        return
    assert port == jax, (path, port, jax)


def _obs(trees, side):
    tel = json.loads(trees[side]["telemetry.json"])
    hist = [json.loads(ln) for ln in trees[side]["history.jsonl"].decode().splitlines()]
    return tel, hist


def test_obs_files_have_the_jax_schema(runs):
    *_, trees, executor = runs
    for rel in BY_SCHEMA:
        assert (rel in trees["port"]) is (rel in trees["jax"]), rel
    assert "logs/trace.json" not in trees["port"]  # the default level is "on"
    (tel, hist), (jtel, jhist) = _obs(trees, "port"), _obs(trees, "jax")
    graph = executor == "graph"
    assert ("graph" in tel) is ("graph" in jtel) is graph
    assert ("graftcheck" in tel["analysis"]) is ("overlap_pool" not in tel) is graph
    _assert_same_schema(_schema(tel), _schema(jtel))
    assert tel["telemetry"] == jtel["telemetry"] == "on"
    assert tel["analysis"]["compile_cache"]["armed"] is True
    (entry,), (jentry,) = hist, jhist
    assert set(entry) == set(jentry)
    _assert_same_schema(_schema({k: v for k, v in entry.items() if k != "stages"}),
                        _schema({k: v for k, v in jentry.items() if k != "stages"}))


def test_graph_sections_equal_jax(runs):
    """graftcheck's verdict and per-node memory estimate, the executed
    graph's nodes and edges, and the donation verdicts (both packages probe
    host arrays on the CPU) are the JAX run's."""
    *_, trees, executor = runs
    (tel, hist), (jtel, jhist) = _obs(trees, "port"), _obs(trees, "jax")
    if executor != "graph":
        assert "graph" not in tel and "graftcheck" not in hist[0]
        return
    assert tel["analysis"]["graftcheck"] == jtel["analysis"]["graftcheck"]
    assert hist[0]["graftcheck"] == jhist[0]["graftcheck"]
    assert tel["transfers"]["static_hbm_by_node"] == jtel["transfers"]["static_hbm_by_node"]
    assert tel["transfers"]["donation"] == jtel["transfers"]["donation"]
    assert hist[0]["donation"] == jhist[0]["donation"]
    for key in ("edges", "shardings", "side_sinks", "results"):
        assert tel["graph"].get(key) == jtel["graph"].get(key), key
    nodes, jnodes = tel["graph"]["nodes"], jtel["graph"]["nodes"]
    assert sorted(nodes) == sorted(jnodes)
    for name, node in nodes.items():
        for key in ("runs", "skips", "inputs", "outputs", "units"):
            assert node.get(key) == jnodes[name].get(key), (name, key)
    assert sorted(hist[0]["nodes"]) == sorted(jhist[0]["nodes"])


def test_obs_files_carry_the_jax_names_and_counts(runs):
    *_, trees, _ = runs
    (tel, hist), (jtel, jhist) = _obs(trees, "port"), _obs(trees, "jax")
    assert sorted(tel["stages"]) == sorted(jtel["stages"])
    assert sorted(hist[0]["stages"]) == sorted(jhist[0]["stages"])
    assert sorted(tel["dispatch"]) == sorted(jtel["dispatch"])
    for site, d in tel["dispatch"].items():
        jd = jtel["dispatch"][site]
        assert d["dispatches"] == jd["dispatches"], site
        assert d["gets"] == jd["gets"], site
    # by stage: assign's readbacks run on a thread outside every stage span
    # in both packages (their label is "")
    by_stage, jby_stage = tel["dispatch_by_stage"], jtel["dispatch_by_stage"]
    assert sorted(by_stage) == sorted(jby_stage)
    for stage, d in by_stage.items():
        assert (d["dispatches"], d["gets"]) == (jby_stage[stage]["dispatches"],
                                                jby_stage[stage]["gets"]), stage
    assert tel["histograms"] == jtel["histograms"]  # the polish chunks' sizes
    assert sorted(tel["counters"]) == sorted(jtel["counters"])
    for name in ("assign.batches", "cluster.batched", "polish.chunks", "donation.audit"):
        assert tel["counters"].get(name) == jtel["counters"].get(name), name
    assert tel["gauges"].keys() == jtel["gauges"].keys() == {"host.rss_bytes"}
    assert tel["compile"]["count"] == 0  # no kernel is built on the CPU
    assert tel["robustness_events"] == jtel["robustness_events"] == {}


def test_history_has_one_entry_with_the_jax_fingerprint(runs):
    *_, trees, _ = runs
    (_, hist), (_, jhist) = _obs(trees, "port"), _obs(trees, "jax")
    assert len(hist) == len(jhist) == 1
    assert hist[0]["fingerprint"] == jhist[0]["fingerprint"]
    assert hist[0]["backend"] == jhist[0]["backend"] == "cpu"
    assert hist[0]["source"] == "run" and hist[0]["schema"] == jhist[0]["schema"]


def test_stage_timing_carries_the_jax_stage_names(runs):
    *_, trees, _ = runs

    def table(side):
        rows = trees[side][TIMING].decode().splitlines()
        assert rows[0] == "stage\tseconds\tcalls"
        seconds = [float(r.split("\t")[1]) for r in rows[1:]]
        assert seconds == sorted(seconds, reverse=True)  # largest first, as in JAX
        return sorted(r.split("\t")[0] for r in rows[1:])

    assert table("port") == table("jax")
    assert "round1_error_profile_bg" in table("port")


def test_counts_equal_the_truth(runs):
    lib, out, jax_results, lane, *_ = runs
    rows = out["port"]["counts/umi_consensus_counts.csv"].decode().splitlines()
    assert rows[0] == "TCR,Count"
    got = {k: int(v) for k, v in (r.rsplit(",", 1) for r in rows[1:])}
    assert got == jax_results["barcode01"]
    if lane != "lowdepth":
        assert got == lib.true_counts
        fasta = out["port"]["fasta/merged_consensus.fasta"].decode()
        assert fasta.count(">") == sum(lib.true_counts.values())
    else:  # the polisher changed the consensus, and the counts moved towards the truth
        vote_rows = out["vote"]["counts/umi_consensus_counts.csv"].decode().splitlines()[1:]
        vote = {k: int(v) for k, v in (r.rsplit(",", 1) for r in vote_rows)}
        assert out["port"]["fasta/merged_consensus.fasta"] != out["vote"][
            "fasta/merged_consensus.fasta"]

        def missed(counts):
            return sum(abs(counts.get(k, 0) - lib.true_counts.get(k, 0))
                       for k in set(counts) | set(lib.true_counts))

        assert missed(got) < missed(vote)


def test_the_card_is_the_default_and_its_absence_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.run_with_config(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.run_with_config(cfg, device="cuda")
    assert not (tmp_path / "nano_tcr").exists()  # nothing ran
