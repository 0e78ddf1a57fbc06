"""The last public functions of the JAX package to get a port twin, each held
to its JAX twin on the same seeded inputs: ``vote_columns`` (one cluster
through ``vote_columns_batch``) and ``pileup_columns_batch``;
``expected_errors`` and ``ee_rate_mask``; ``phred_batch``,
``decode_phred_batch`` and ``encode_mask_batch``; ``diag_offset`` (its floor
division: the mutation that truncates toward zero is caught);
``fastq_stats`` and ``count_fasta_records`` on plain and gzipped files;
``region_length_dict`` and ``countable_regions``; ``polish_clusters_stage``
(one group through ``polish_clusters_all``, and its refusal of a failed
group); the numpy references ``fuzzy_find_np`` and ``align_np``. And the
name diff: every public top-level function or class of a JAX module has a
twin of that name in the port's module of the same path, but for the
JAX-only names (``ROADMAP.md``, "Not to port"). Tolerance: exact, but the
expected errors (float32 sums in another order: rtol 1e-6)."""

import ast
import gzip
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ont_tcrconsensus_tpu.cluster import regions as jregions  # noqa: E402
from ont_tcrconsensus_tpu.io import fastx as jfastx  # noqa: E402
from ont_tcrconsensus_tpu.ops import consensus as jconsensus  # noqa: E402
from ont_tcrconsensus_tpu.ops import ee_filter as jee  # noqa: E402
from ont_tcrconsensus_tpu.ops import encode as jencode  # noqa: E402
from ont_tcrconsensus_tpu.ops import fuzzy_match as jfuzzy  # noqa: E402
from ont_tcrconsensus_tpu.ops import pileup as jpileup  # noqa: E402
from ont_tcrconsensus_tpu.ops import sketch as jsketch  # noqa: E402
from ont_tcrconsensus_tpu.ops import sw_align as jsw  # noqa: E402
from ont_tcrconsensus_tpu.pipeline import stages as jstages  # noqa: E402
from ont_tcrconsensus_tpu_torch.cluster import regions  # noqa: E402
from ont_tcrconsensus_tpu_torch.io import dp_cases, fastx  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import (  # noqa: E402
    consensus, ee_filter, encode, fuzzy_match, pileup, sketch, sw_align)
from ont_tcrconsensus_tpu_torch.pipeline import stages  # noqa: E402
from test_torch_assign_drive import _polish_inputs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the JAX package's names that exist only because of JAX or the TPU, each
#: beside its port counterpart (ROADMAP.md, "Not to port")
JAX_ONLY = {
    ("pipeline/run.py", "enable_compilation_cache"): "ops/_build.use_build_dir",
    ("obs/device.py", "install_compile_listener"): "obs/device.kernel_built",
    ("models/polisher.py", "BiGRU"): "ConsensusPolisher's torch.nn.GRU(bidirectional=True)",
    ("ops/sw_pallas.py", "align_banded_pallas"): "ops/sw_kernel.align_banded_cuda (B1)",
    ("ops/sw_pallas.py", "align_banded_auto"): "ops/sw_kernel.align_banded_auto",
    ("ops/pileup_pallas.py", "forward_planes_pallas"): "ops/pileup_kernel.forward_planes_cuda",
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pileup_case(seed: int, C: int = 2, S: int = 5, W: int = 128):
    rng = np.random.default_rng(seed)
    rows, drafts = [], []
    for _ in range(C):
        tpl = rng.integers(0, 4, int(rng.integers(70, 110))).astype(np.uint8)
        drafts.append(dp_cases.noisy_copy(rng, tpl, 0.05))
        rows += [dp_cases.noisy_copy(rng, tpl, 0.08) for _ in range(S)]
    sub, lens = dp_cases.pack(rows, W)
    d, dl = dp_cases.pack(drafts, W)
    return sub.reshape(C, S, W), lens.reshape(C, S), d, dl


def test_pileup_columns_batch_and_vote_columns_equal_jax():
    sub, lens, drafts, dlens = _pileup_case(1)
    got = pileup.pileup_columns_batch(*map(_t, (sub, lens, drafts, dlens)), band_width=64)
    want = jpileup.pileup_columns_batch(sub, lens, jnp.asarray(drafts), jnp.asarray(dlens),
                                        band_width=64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for c in range(2):
        draft, dlen = consensus.vote_columns(got[0][c], got[1][c], got[2][c], _t(drafts[c]),
                                             int(dlens[c]))
        jdraft, jdlen = jconsensus.vote_columns(want[0][c], want[1][c], want[2][c],
                                                jnp.asarray(drafts[c]), jnp.int32(dlens[c]))
        assert draft.dtype == torch.uint8 and draft.shape == (2 * drafts.shape[1],)
        np.testing.assert_array_equal(draft.numpy(), np.asarray(jdraft))
        assert int(dlen) == int(jdlen) > 0


def test_expected_errors_and_ee_rate_mask_equal_jax():
    rng = np.random.default_rng(2)
    quals = rng.integers(8, 42, (40, 96)).astype(np.uint8)
    lengths = rng.integers(0, 97, 40).astype(np.int32)
    lengths[:2] = 0
    ee = ee_filter.expected_errors(_t(quals), _t(lengths))
    jee_ = np.asarray(jee.expected_errors(quals, lengths))
    assert ee.dtype == torch.float32
    np.testing.assert_allclose(ee.numpy(), jee_, rtol=1e-6)
    rate = jee_ / np.maximum(lengths, 1)
    for max_rate, min_len in ((0.025, 10), (0.045, 0), (0.02, 40)):
        # no read within float32 rounding of the limit: the masks must agree
        assert (np.abs(rate - max_rate) > 1e-5).all()
        got = ee_filter.ee_rate_mask(_t(quals), _t(lengths), max_rate, min_len)
        want = np.asarray(jee.ee_rate_mask(quals, lengths, max_rate, min_len))
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < len(want)


def test_encoders_equal_jax():
    rng = np.random.default_rng(3)
    quals = ["".join(chr(33 + q) for q in rng.integers(0, 60, n)) for n in (0, 5, 130, 40)]
    for kw in ({}, {"pad_to": 200, "multiple": 1}, {"multiple": 64}):
        got, want = encode.phred_batch(quals, **kw), jencode.phred_batch(quals, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert encode.decode_phred_batch(*got) == jencode.decode_phred_batch(*want) == quals
    with pytest.raises(ValueError, match="below Phred-33"):
        encode.phred_batch(["II\x1fI"])
    seqs = ["ACGTNRYKMSWBDHV", "", "acgtu", "TTTVVTTVVVVTTT"]
    for kw in ({}, {"pad_to": 20, "multiple": 1}):
        got, want = encode.encode_mask_batch(seqs, **kw), jencode.encode_mask_batch(seqs, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_diag_offset_equals_jax_and_truncation_is_caught():
    rng = np.random.default_rng(4)
    read_lens = rng.integers(0, 3000, 64).astype(np.int32)
    ref_lens = rng.integers(0, 3000, 64).astype(np.int32)
    got = sketch.diag_offset(_t(read_lens), _t(ref_lens))
    want = np.asarray(jsketch.diag_offset(jnp.asarray(read_lens), jnp.asarray(ref_lens)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(sketch.diag_offset(read_lens, ref_lens), want)
    truncated = -np.trunc((read_lens - ref_lens) / 2).astype(np.int32)
    assert (truncated != want).any()


def test_fastx_stats_and_regions_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    records = []
    for i in range(7):
        n = int(rng.integers(1, 80))
        seq = "".join("ACGT"[b] for b in rng.integers(0, 4, n))
        qual = "".join(chr(33 + q) for q in rng.integers(0, 41, n))
        records.append((f"read{i} x=1", seq, qual))
    for name in ("r.fastq", "r.fastq.gz"):
        fastx.write_fastq(tmp_path / name, records)
        assert fastx.fastq_stats(tmp_path / name) == jfastx.fastq_stats(tmp_path / name)
    reference = {"TCR0001": "ACGT" * 30, "TCR0002_v_n": "AC" * 7, "ctl_full_n": "G",
                 "TCR0003cdr3j_n": "T" * 9, "TCR0004": "ACGTT" * 11}
    for name in ("ref.fa", "ref.fa.gz"):
        fastx.write_fasta(tmp_path / name, reference.items())
        assert fastx.count_fasta_records(tmp_path / name) == 5
        assert fastx.count_fasta_records(tmp_path / name) == jfastx.count_fasta_records(
            tmp_path / name)
        assert fastx.fastq_stats(tmp_path / name) == jfastx.fastq_stats(tmp_path / name)
    with gzip.open(tmp_path / "cut.fa.gz", "wb") as fh:
        fh.write(b">a\nACGT\n" * 400)
    (tmp_path / "cut.fa.gz").write_bytes((tmp_path / "cut.fa.gz").read_bytes()[:-30])
    with pytest.raises(ValueError, match="truncated or corrupt gzip"):
        fastx.count_fasta_records(tmp_path / "cut.fa.gz")
    assert regions.region_length_dict(reference) == jregions.region_length_dict(reference)
    assert regions.countable_regions(reference) == jregions.countable_regions(reference) == {
        "TCR0001", "TCR0004"}


def test_polish_clusters_stage_equals_jax(monkeypatch):
    (store, selected), (jstore, jselected) = _polish_inputs(n_clusters=1)
    (group, clusters), (_, jclusters) = selected[0], jselected[0]
    got = stages.polish_clusters_stage(clusters, group, store, cluster_batch=2, device="cpu")
    want = jstages.polish_clusters_stage(jclusters, group, jstore, cluster_batch=2)
    assert got == want and len(got) == 1
    failed = ({}, {group: "ValueError: refused"})
    monkeypatch.setattr(stages, "polish_clusters_all", lambda *a, **k: failed)
    monkeypatch.setattr(jstages, "polish_clusters_all", lambda *a, **k: failed)
    msgs = []
    for mod, (st, cl) in ((stages, (store, clusters)), (jstages, (jstore, jclusters))):
        with pytest.raises(RuntimeError) as err:
            mod.polish_clusters_stage(cl, group, st)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == f"polish failed for {group}: ValueError: refused"


def test_numpy_references_equal_jax():
    rng = np.random.default_rng(6)
    for _ in range(6):
        pattern = "".join(rng.choice(list("ACGTRYN"), int(rng.integers(1, 9))))
        text = "".join(rng.choice(list("ACGT"), int(rng.integers(0, 20))))
        assert fuzzy_match.fuzzy_find_np(pattern, text) == jfuzzy.fuzzy_find_np(pattern, text)
    for _ in range(4):
        read = rng.integers(0, 5, int(rng.integers(0, 30))).astype(np.uint8)
        ref = dp_cases.noisy_copy(rng, read, 0.2)
        got, want = sw_align.align_np(read, ref), jsw.align_np(read, ref)
        for f in ("score", "read_start", "read_end", "ref_start", "ref_end", "n_match",
                  "n_cols"):
            assert int(getattr(got, f)) == int(getattr(want, f)), f
        assert float(got.blast_id) == pytest.approx(float(got.n_match) / max(int(got.n_cols), 1))


def _public_names(path: str) -> set[str]:
    with open(path) as fh:
        tree = ast.parse(fh.read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def test_every_public_jax_name_has_a_port_twin_but_the_jax_only_ones():
    jax_root = os.path.join(REPO, "ont_tcrconsensus_tpu")
    port_root = os.path.join(REPO, "ont_tcrconsensus_tpu_torch")
    missing = set()
    for root, _, files in os.walk(jax_root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), jax_root)
                port = os.path.join(port_root, rel)
                have = _public_names(port) if os.path.exists(port) else set()
                missing |= {(rel, n) for n in _public_names(os.path.join(root, f)) - have}
    assert missing == set(JAX_ONLY)
    with open(os.path.join(REPO, "ROADMAP.md")) as fh:
        roadmap = fh.read()
    for rel, name in JAX_ONLY:
        assert f"{rel[:-3]}.{name}" in roadmap, name
