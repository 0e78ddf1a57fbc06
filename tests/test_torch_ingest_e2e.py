"""Ingest validation end to end, the port against the JAX package: the tests'
4-region lane (seed 11, 73 reads) with the ``corrupt-input`` chaos drill
(three malformed blocks spliced between records) under ``on_bad_record``
``quarantine`` and ``drop`` and ``contracts: "strict"``. Each package runs
in turn in the same directory (the report names the input's path), JAX
first. Every file under ``nano_tcr/`` must be byte-identical, but the
files of timings (by schema, as in ``test_torch_e2e.py``), the quarantine
gzip (its header's MTIME masked, and decompressed) and
``robustness_report.json`` (equal but for each event's clock fields). The
counts are the clean lane's: the bad records never reach a batch.

The port ingests a path through its native C++ parser where that builds
(``io/native``); :data:`PYTHON_INGEST` runs it once more beside a JAX run
with ``native.available`` patched to False (the Python parsers), and the
JAX clean run is matched by the port's clean run on the Python parsers
too. Each port run counts the path sources each ingest path read."""

import gzip
import importlib.util
import json
import os
import shutil

import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.run import run_with_config as jax_run  # noqa: E402
from ont_tcrconsensus_tpu.robustness import faults as jfaults  # noqa: E402
from ont_tcrconsensus_tpu_torch.io import native, simulator  # noqa: E402
from ont_tcrconsensus_tpu_torch.io import validate as TV  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import assign as tassign  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import cli  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import run as trun  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import faults as tfaults  # noqa: E402
from test_torch_chaos import disarm  # noqa: E402
from test_torch_e2e import (  # noqa: E402,F401  (autouse)
    BY_SCHEMA,
    LANES,
    NOT_BYTE_COMPARED,
    _assert_same_schema,
    _lane_dir,
    _obs,
    _one_torch_thread,
    _schema,
    _tree,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORRUPT = [{"site": "ingest.library_fastq", "kind": "corrupt-input"}]
QUARANTINE = "barcode01/quarantine.fastq.gz"
REPORT = "robustness_report.json"
# (policy, executor, extra chaos specs). The graph run also takes a
# transient fault at the first batch's dispatch: the whole ingest pass
# retries, and the guard resets with it, so nothing is counted twice.
RUNS = {
    "quarantine-graph-retry": ("quarantine", "graph",
                               [{"site": "assign.dispatch", "kind": "transient"}]),
    "quarantine-imperative": ("quarantine", "imperative", []),
    "drop-graph": ("drop", "graph", []),
}
# the port's runs on the Python parsers, by the RUNS entry whose JAX run
# (and directory) each shares
PYTHON_INGEST = {"quarantine-graph-retry-python": "quarantine-graph-retry"}


@pytest.fixture(autouse=True)
def _disarm():
    yield
    disarm()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def lane():
    return simulator.simulate_library(**LANES["clean"])


def _port_run(cfg_path, use_native: bool) -> dict:
    """The port through its CLI on the CPU; how many path sources each
    ingest path read (the native parser's columnar batches, the Python
    parsers' record batches). Round 2 of the imperative executor batches
    consensus records, not a path, and is not counted."""
    calls = {"native": 0, "python": 0}
    by_maker = {"batch_parsed_chunks": "native", "batch_reads": "python"}
    batches_from_source = tassign._batches_from_source

    def counting(source, *args, **kwargs):
        batches = batches_from_source(source, *args, **kwargs)
        if isinstance(source, (str, bytes, os.PathLike)):
            calls[by_maker[batches.gi_code.co_name]] += 1
        return batches

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tassign, "_batches_from_source", counting)
        if not use_native:
            m.setattr(native, "available", lambda: False)
        assert cli.main([str(cfg_path), "--cpu"]) == 0
    return calls


def _run_both(root, cfg: dict, python: bool = False) -> dict:
    """JAX, then the port (through its CLI on the CPU), and, if ``python``,
    the port on the Python parsers, in ``root``: each side's counts, tree,
    chaos fires and (the port's) read batches by ingest path."""
    out = {}
    cfg_path = root / "port_config.json"
    cfg_path.write_text(json.dumps(cfg))
    for side in ("jax", "port") + (("python",) if python else ()):
        shutil.rmtree(root / "fastq_pass" / "nano_tcr", ignore_errors=True)
        calls = None
        if side == "jax":
            counts = jax_run(JConfig.from_dict(cfg))["barcode01"]
            fired = jfaults.fired("ingest.library_fastq")
        else:
            calls = _port_run(cfg_path, use_native=side == "port")
            counts = None
            fired = tfaults.fired("ingest.library_fastq")
        out[side] = {"counts": counts, "tree": _tree(root), "fired": fired, "calls": calls}
        disarm()
    return out


@pytest.fixture(scope="module")
def ingest(tmp_path_factory, lane):
    """Every run of :data:`RUNS` on both packages (and of
    :data:`PYTHON_INGEST` on the port), and the JAX package's clean run of
    the lane (under the graph executor, as the first) with the port's on
    the Python parsers in its directory."""
    out = {}
    for name, (policy, executor, extra) in RUNS.items():
        root = tmp_path_factory.mktemp(f"ingest_{name}") / "lane"
        cfg = _lane_dir(root, lane, "rnn", "clean", executor)
        cfg.update(on_bad_record=policy, contracts="strict", chaos=CORRUPT + extra)
        out[name] = _run_both(root, cfg, python=name in PYTHON_INGEST.values())
        out[name].update(policy=policy, name=name, lane=lane, executor=executor,
                         retried=bool(extra), parser="native")
    for name, of in PYTHON_INGEST.items():
        out[name] = {**out[of], "port": out[of]["python"], "name": name, "parser": "python"}
    root = tmp_path_factory.mktemp("ingest_clean") / "lane"
    cfg = _lane_dir(root, lane, "rnn", "clean")
    jax_run(JConfig.from_dict(cfg))
    out["clean"] = _tree(root)
    shutil.rmtree(root / "fastq_pass" / "nano_tcr")
    cfg_path = root / "port_config.json"
    cfg_path.write_text(json.dumps(cfg))
    out["clean-python"] = {"calls": _port_run(cfg_path, use_native=False), "tree": _tree(root)}
    return out


@pytest.fixture(params=sorted(RUNS) + sorted(PYTHON_INGEST))
def runs(request, ingest):
    return ingest[request.param]


def _events(tree) -> list[dict]:
    """The report's events without their clock fields."""
    return [{k: v for k, v in e.items() if k not in ("t_wall", "t_mono")}
            for e in json.loads(tree[REPORT])["events"]]


def test_counts_are_the_clean_lane_s(runs):
    rows = runs["port"]["tree"]["barcode01/counts/umi_consensus_counts.csv"].decode()
    got = {k: int(v) for k, v in (r.rsplit(",", 1) for r in rows.splitlines()[1:])}
    assert got == runs["jax"]["counts"] == runs["lane"].true_counts
    assert runs["port"]["fired"] == runs["jax"]["fired"] == 1


def test_every_file_is_the_jax_run_s(runs):
    port, jax = runs["port"]["tree"], runs["jax"]["tree"]
    assert sorted(port) == sorted(jax)
    skip = set(NOT_BYTE_COMPARED) | {QUARANTINE, REPORT}
    compared = sorted(set(jax) - skip)
    assert "barcode01/logs/ee_filter.log" in compared
    assert [rel for rel in compared if port[rel] != jax[rel]] == []


def test_the_report_equals_jax_but_for_the_clocks(runs):
    port, jax = (json.loads(runs[side]["tree"][REPORT]) for side in ("port", "jax"))
    assert _events(runs["port"]["tree"]) == _events(runs["jax"]["tree"])
    for key in set(port) | set(jax):
        if key != "events":
            assert port.get(key) == jax.get(key), key
    assert port["contracts"]["mode"] == "strict" and port["contracts"]["violated"] == {}
    assert port["contracts"]["checked"]["ingest"] >= 1


def test_the_ingest_events_name_each_spliced_block(runs):
    events = [e for e in _events(runs["port"]["tree"]) if e["site"] == "ingest.quarantine"]
    outcome = "quarantined" if runs["policy"] == "quarantine" else "dropped"
    assert [e["outcome"] for e in events] == [outcome] * 3 + ["summary"]
    assert {e["classification"] for e in events} == {"data_fault"}
    reasons = {TV.R_NOT_FASTX, TV.R_BAD_HEADER, TV.R_MISSING_PLUS, TV.R_LEN_MISMATCH,
               TV.R_BAD_QUAL, TV.R_TRUNCATED}
    assert {e["detail"]["reason"] for e in events[:3]} <= reasons
    summary = events[-1]["detail"]
    assert summary["n_bad"] == 3 and summary["policy"] == runs["policy"]
    assert summary["source"].endswith("barcode01.chaos-corrupt.gz")
    others = [e["site"] for e in _events(runs["port"]["tree"])
              if e["site"] != "ingest.quarantine"]
    if runs["retried"]:  # retried once, counted once
        assert others == ["assign.round1", "assign.round1"]
    else:
        assert others == []


def test_the_quarantine_artifact_is_the_jax_run_s(runs):
    port, jax = runs["port"]["tree"], runs["jax"]["tree"]
    if runs["policy"] == "drop":
        assert QUARANTINE not in port and QUARANTINE not in jax
        return
    # the gzip header's MTIME (bytes 4-7) is the wall clock in both packages
    assert port[QUARANTINE][:4] + port[QUARANTINE][8:] == jax[QUARANTINE][:4] + jax[QUARANTINE][8:]
    raw = gzip.decompress(port[QUARANTINE])
    assert raw == gzip.decompress(jax[QUARANTINE])
    # exactly the three spliced blocks, each one of the chaos blocks
    rest = raw
    for _ in range(3):
        block = next(b for b in tfaults._CORRUPT_BLOCKS if rest.startswith(b))
        rest = rest[len(block):]
    assert rest == b""


def test_the_files_of_timings_have_the_jax_schema(runs):
    trees = {side: runs[side]["tree"] for side in ("port", "jax")}
    for rel in BY_SCHEMA:
        assert (rel in trees["port"]) is (rel in trees["jax"]), rel
    (tel, hist), (jtel, jhist) = _obs(trees, "port"), _obs(trees, "jax")
    _assert_same_schema(_schema(tel), _schema(jtel))
    assert tel["robustness_events"] == jtel["robustness_events"]
    assert hist[0]["fingerprint"] == jhist[0]["fingerprint"]
    assert ("graph" in tel) is ("graph" in jtel) is (runs["executor"] == "graph")


def test_the_port_ingests_through_the_parser_it_was_given(runs):
    calls = runs["port"]["calls"]
    if runs["parser"] == "native" and native.available():
        assert calls["native"] >= 1 and calls["python"] == 0
    else:
        assert calls["native"] == 0 and calls["python"] >= 1


def test_native_and_python_ingest_write_the_same_files(ingest):
    for name, of in PYTHON_INGEST.items():
        a, b = ingest[of]["port"]["tree"], ingest[name]["port"]["tree"]
        assert sorted(a) == sorted(b)
        skip = set(NOT_BYTE_COMPARED) | {QUARANTINE, REPORT}
        assert [rel for rel in sorted(a) if rel not in skip and a[rel] != b[rel]] == []


def test_native_and_python_ingest_quarantine_the_same_records(ingest):
    for name, of in PYTHON_INGEST.items():
        a, b = ingest[of]["port"]["tree"], ingest[name]["port"]["tree"]
        assert _events(a) == _events(b)
        assert gzip.decompress(a[QUARANTINE]) == gzip.decompress(b[QUARANTINE])


def test_a_clean_run_on_the_python_parsers_writes_the_jax_run_s_files(ingest, lane):
    port, jax = ingest["clean-python"]["tree"], ingest["clean"]
    calls = ingest["clean-python"]["calls"]
    assert calls["native"] == 0 and calls["python"] >= 1
    assert sorted(port) == sorted(jax)
    compared = sorted(set(jax) - set(NOT_BYTE_COMPARED))
    assert REPORT in compared and QUARANTINE not in compared
    assert [rel for rel in compared if port[rel] != jax[rel]] == []
    rows = port["barcode01/counts/umi_consensus_counts.csv"].decode().splitlines()[1:]
    assert {k: int(v) for k, v in (r.rsplit(",", 1) for r in rows)} == lane.true_counts


def test_a_clean_and_a_corrupted_jax_run_differ_only_where_chip_smoke_allows(ingest):
    """``chip_smoke.py``'s ingest phase compares the card's quarantine run
    with its clean run on every file but those it names as differing: the
    JAX package's own clean and corrupted (quarantine, graph) runs must
    differ in no other."""
    chip_smoke = _chip_smoke()
    clean, corrupt = ingest["clean"], ingest["quarantine-graph-retry"]["jax"]["tree"]
    differ = sorted(rel for rel in set(clean) | set(corrupt)
                    if clean.get(rel) != corrupt.get(rel))
    allowed = set(chip_smoke.TIMED_FILES) | set(chip_smoke.INGEST_DIFFERS)
    assert [rel for rel in differ if rel not in allowed] == []
    assert set(chip_smoke.INGEST_DIFFERS) <= set(differ)


def test_a_truncated_gzip_under_quarantine_completes_with_a_gzip_reason(tmp_path, lane):
    """``truncate-file`` cuts the gzip stream: the library completes on the
    decodable prefix, and the loss is a quarantine event with a gzip
    reason, as in the JAX package. The tolerant parser reads the whole
    file (the native parser's first chunk, at this size) before the first
    record is batched, so the run takes only the first 24 reads
    (``dorado_trim_subsample_fastq``) and the event is still there."""
    cfg = _lane_dir(tmp_path / "lane", lane, "poa", "clean")
    cfg.update(on_bad_record="quarantine", dorado_trim_subsample_fastq=24,
               chaos=[{"site": "ingest.library_fastq", "kind": "truncate-file"}])
    got = trun.run_with_config(RunConfig.from_dict(cfg), device="cpu")
    assert tfaults.fired("ingest.library_fastq") == 1 and "barcode01" in got
    tree = _tree(tmp_path / "lane")
    reasons = [e["detail"].get("reason", "") for e in _events(tree)
               if e["site"] == "ingest.quarantine" and e["outcome"] != "summary"]
    assert TV.R_GZIP in reasons
    assert "barcode01/counts/umi_consensus_counts.csv" in tree


def test_a_quarantine_run_on_the_card_without_one_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RunConfig.from_dict({"reference_file": str(tmp_path / "reference.fa"),
                               "fastq_pass_dir": str(tmp_path),
                               "on_bad_record": "quarantine"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.run_with_config(cfg)
    assert not (tmp_path / "nano_tcr").exists()


def test_the_clean_python_run_s_files_of_timings_have_the_jax_schema(ingest):
    trees = {"port": ingest["clean-python"]["tree"], "jax": ingest["clean"]}
    for rel in BY_SCHEMA:
        assert (rel in trees["port"]) is (rel in trees["jax"]), rel
    (tel, hist), (jtel, jhist) = _obs(trees, "port"), _obs(trees, "jax")
    _assert_same_schema(_schema(tel), _schema(jtel))
    assert hist[0]["fingerprint"] == jhist[0]["fingerprint"]
