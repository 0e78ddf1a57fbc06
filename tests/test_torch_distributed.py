"""Multi-process distribution of the port (``parallel/distributed.py``)
against the JAX package's.

The library sharding, the single-process gather and merge, and the
bring-up rules are compared with the JAX package's functions. Two real
processes then join one gloo process group over localhost: first for
``allgather_object`` and ``barrier`` alone, then, as the JAX package's
``tests/test_distributed.py`` does, each running the port's pipeline on
its share of a two-library lane on the CPU. Both must return the merged
counts (the truth), each library's files must equal a single-process
run's, and the per-process files carry the JAX package's names
(``robustness_report_p<i>.json``, ``telemetry_p<i>.json``,
``history_p<i>.jsonl``, ``stack_dumps_p<i>.log``; its
``pipeline/run.py``). Every process runs under a timeout, so a hung peer
fails the test, and tears its group down in a ``finally``."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu.io import fastx as jfastx  # noqa: E402
from ont_tcrconsensus_tpu.io import simulator as jsim  # noqa: E402
from ont_tcrconsensus_tpu.parallel import distributed as jdist  # noqa: E402
from ont_tcrconsensus_tpu_torch.parallel import distributed as dist  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


@pytest.mark.parametrize("n,count", [(5, 3), (4, 2), (7, 4), (2, 1), (3, 5)])
def test_shard_libraries_equals_jax(n, count):
    paths = [f"fastq_pass/barcode{i:02d}/x.fastq" for i in range(n)][::-1]
    shards = [dist.shard_libraries(paths, index=i, count=count) for i in range(count)]
    assert shards == [jdist.shard_libraries(paths, index=i, count=count)
                      for i in range(count)]
    if count > 1:
        assert sorted(sum(shards, [])) == sorted(paths)
    else:
        assert shards == [paths]  # one process keeps the given order


def test_single_process_gather_and_merge_equal_jax():
    assert not torch.distributed.is_initialized()
    assert dist.process_index() == jdist.process_index() == 0
    assert dist.process_count() == jdist.process_count() == 1
    obj = {"lib": {"r": 2}, "x": [1, 2]}
    assert dist.allgather_object(obj) == jdist.allgather_object(obj) == [obj]
    assert dist.merge_results({"lib": {"r": 2}}) == jdist.merge_results({"lib": {"r": 2}})
    assert dist.shard_libraries(["b", "a"]) == ["b", "a"]
    dist.barrier("noop")  # single-process: returns at once


def test_bring_up_rules(monkeypatch, capsys):
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    dist.initialize()  # nothing to find: a note, and the run goes on alone
    assert "continuing single-process" in capsys.readouterr().err
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="no coordinator"):
        dist.initialize(required=True)
    with pytest.raises(ValueError, match="needs num_processes"):
        dist.initialize("localhost:1", num_processes=2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(script: str, args_of, env_of, n=2, meanwhile=None):
    """Run ``script`` in ``n`` processes (``meanwhile()`` runs here while
    they do); their standard outputs, each process held to exit 0."""
    procs = [subprocess.Popen([sys.executable, "-c", script, *args_of(i)], env=env_of(i),
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(n)]
    outs = []
    try:
        if meanwhile is not None:
            meanwhile()
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


_GATHER = textwrap.dedent("""
    import json, sys
    from ont_tcrconsensus_tpu_torch.parallel import distributed as dist
    import torch.distributed as tdist
    port, rank = sys.argv[1], int(sys.argv[2])
    dist.initialize(f"localhost:{port}", num_processes=2, process_id=rank, required=True)
    try:
        dist.barrier("start")
        got = dist.allgather_object({"rank": rank, "libs": {f"barcode0{rank}": {"r": rank}}})
        merged = dist.merge_results({f"barcode0{rank}": {"r": rank + 1}})
        dist.barrier("end")
        print(json.dumps({"index": dist.process_index(), "count": dist.process_count(),
                          "got": got, "merged": merged,
                          "shard": dist.shard_libraries(["c", "a", "b"])}))
    finally:
        tdist.destroy_process_group()
""")


def test_two_gloo_processes_gather_and_meet():
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    outs = _spawn(_GATHER, lambda i: (str(port), str(i)), lambda i: env)
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    want = [{"libs": {"barcode00": {"r": 0}}, "rank": 0},
            {"libs": {"barcode01": {"r": 1}}, "rank": 1}]
    for i, r in enumerate(reports):
        assert (r["index"], r["count"]) == (i, 2)
        assert r["got"] == want
        assert r["merged"] == {"barcode00": {"r": 1}, "barcode01": {"r": 2}}
    assert [r["shard"] for r in reports] == [["a", "c"], ["b"]]


_PIPELINE = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from ont_tcrconsensus_tpu_torch.parallel import distributed as dist
    from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig
    from ont_tcrconsensus_tpu_torch.pipeline.run import run_with_config
    import torch.distributed as tdist
    cfg_path, out_path = sys.argv[1], sys.argv[2]
    dist.initialize(required=True)  # torchrun's variables
    try:
        results = run_with_config(RunConfig.from_json(cfg_path), device="cpu")
        with open(out_path, "w") as fh:
            json.dump(results, fh)
    finally:
        tdist.destroy_process_group()
""")

# the run-level files process 0 alone writes, and the per-process ones
RUN_LEVEL = ["ref_homology_out_generate_region_split_dict.log",
             "ref_homology_out_most_similar_region_dict.json", "region_cluster_dict.json",
             "self_homology_stats.json"]


def _per_process(i: int) -> list[str]:
    return [f"history_p{i}.jsonl", f"robustness_report_p{i}.json", f"stack_dumps_p{i}.log",
            f"telemetry_p{i}.json"]


def _two_library_lane(root, lib, distributed):
    jfastx.write_fasta(root / "reference.fa", lib.reference.items())
    for barcode in ("barcode01", "barcode02"):
        (root / "fastq_pass" / barcode).mkdir(parents=True)
        jfastx.write_fastq(root / "fastq_pass" / barcode / f"{barcode}.fastq.gz", lib.reads)
    cfg = {"reference_file": str(root / "reference.fa"),
           "fastq_pass_dir": str(root / "fastq_pass"), "minimal_length": 600,
           "min_reads_per_cluster": 4, "read_batch_size": 64, "polish_method": "poa",
           "delete_tmp_files": False, "distributed": distributed}
    (root / "config.json").write_text(json.dumps(cfg))
    return root / "config.json"


def _nano(root):
    nano = root / "fastq_pass" / "nano_tcr"
    return {p.relative_to(nano).as_posix(): p.read_bytes()
            for p in sorted(nano.rglob("*")) if p.is_file()}


def test_two_processes_shard_the_libraries_and_merge_the_counts(tmp_path):
    lib = jsim.simulate_library(seed=11, num_regions=3, molecules_per_region=(2, 2),
                                reads_per_molecule=(5, 6), sub_rate=0.006, ins_rate=0.003,
                                del_rate=0.003, region_len=(700, 850))
    (tmp_path / "multi").mkdir()
    (tmp_path / "single").mkdir()
    cfg = _two_library_lane(tmp_path / "multi", lib, distributed=True)
    port = _free_port()

    def env_of(i):
        return {**os.environ, "PYTHONPATH": REPO, "MASTER_ADDR": "localhost",
                "MASTER_PORT": str(port), "RANK": str(i), "WORLD_SIZE": "2"}

    outs = [tmp_path / f"results_{i}.json" for i in range(2)]
    want = {"barcode01": lib.true_counts, "barcode02": lib.true_counts}
    single_cfg = _two_library_lane(tmp_path / "single", lib, distributed=False)

    def one_process_run():
        """Both libraries in this process, while the two processes run."""
        from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig
        from ont_tcrconsensus_tpu_torch.pipeline.run import run_with_config

        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            assert run_with_config(RunConfig.from_json(str(single_cfg)), device="cpu") == want
        finally:
            torch.set_num_threads(threads)

    _spawn(_PIPELINE, lambda i: (str(cfg), str(outs[i])), env_of, meanwhile=one_process_run)
    assert [json.loads(o.read_text()) for o in outs] == [want, want]
    multi, single = _nano(tmp_path / "multi"), _nano(tmp_path / "single")
    timing = ("stage_manifest.json", "logs/stage_timing.tsv")
    for barcode in ("barcode01", "barcode02"):
        files = sorted(k for k in single if k.startswith(barcode + "/"))
        assert sorted(k for k in multi if k.startswith(barcode + "/")) == files
        assert [k for k in files if not k.endswith(timing) and multi[k] != single[k]] == []
    top = sorted(k for k in multi if "/" not in k)
    assert top == sorted(RUN_LEVEL + _per_process(0) + _per_process(1))
    for rel in RUN_LEVEL:
        assert multi[rel] == single[rel], rel
    assert sorted(k for k in single if "/" not in k) == sorted(
        RUN_LEVEL + ["history.jsonl", "robustness_report.json", "stack_dumps_p0.log",
                     "telemetry.json"])
    # each process ran its own library: one library's batches in each telemetry
    batches = [json.loads(multi[f"telemetry_p{i}.json"])["counters"]["assign.batches"]
               for i in (0, 1)]
    whole = json.loads(single["telemetry.json"])["counters"]["assign.batches"]
    assert batches[0] == batches[1] and 2 * batches[0] == whole


def test_the_cli_brings_the_group_up_and_a_failed_bring_up_raises(tmp_path):
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"reference_file": str(tmp_path / "r.fa"),
                               "fastq_pass_dir": str(tmp_path), "distributed": True}))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    env.update(PYTHONPATH=REPO, TCR_CONSENSUS_DISTRIBUTED="1")
    out = subprocess.run([sys.executable, "-m", "ont_tcrconsensus_tpu_torch", str(cfg),
                          "--cpu"], env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=TIMEOUT_S)
    assert out.returncode != 0
    assert "no coordinator" in out.stderr
    assert not (tmp_path / "nano_tcr").exists()
