"""The read-assignment slice of the PyTorch port against the JAX package:
EE filter, k-mer sketch (with ``jax.lax.top_k``'s tie order), fuzzy
matching, reference self-homology, the fused and targeted passes, and the
ReadStore/AlignStats of a whole ``run_assign``.

Integer outputs must be equal. Float tolerances: EE values rtol 1e-6 with
equal masks (sums are taken in another order); cosine scores atol 1e-5, and
candidate indices are compared where the cosine gap exceeds 1e-5 (float32
rounding may swap a closer pair).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ont_tcrconsensus_tpu.cluster import regions as jregions  # noqa: E402
from ont_tcrconsensus_tpu.io import fastx as jfastx  # noqa: E402
from ont_tcrconsensus_tpu.io import simulator as jsim  # noqa: E402
from ont_tcrconsensus_tpu.ops import ee_filter as jee  # noqa: E402
from ont_tcrconsensus_tpu.ops import encode as jencode  # noqa: E402
from ont_tcrconsensus_tpu.ops import fuzzy_match as jfuzzy  # noqa: E402
from ont_tcrconsensus_tpu.ops import sketch as jsketch  # noqa: E402
from ont_tcrconsensus_tpu.pipeline import assign as jassign  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig  # noqa: E402
from ont_tcrconsensus_tpu_torch import convert  # noqa: E402
from ont_tcrconsensus_tpu_torch.cluster import regions  # noqa: E402
from ont_tcrconsensus_tpu_torch.io import bucketing, fastx  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import ee_filter, encode, fuzzy_match, sketch  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import assign  # noqa: E402

COS_ATOL = 1e-5
UMI_FWD = "TTTVVTTVVVVTTVVVVTTVVVVTTVVVVTTT"
UMI_REV = "AAABBBBAABBBBAABBBBAABBBBAABBAAA"


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    """Untrimmed reads (adapters + primers) of 3 regions, a near-duplicate
    pair and a negative control, with both packages' identical panel."""
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
    path = tmp_path_factory.mktemp("assign") / "reads.fastq.gz"
    jfastx.write_fastq(path, lib.reads)
    primers = JConfig(reference_file="r", fastq_pass_dir="f").primer_sequences()
    return lib, jpanel, tpanel, path, primers


def _engines(lane, **kw):
    _, jpanel, tpanel, _, primers = lane
    je = jassign.AssignEngine(jpanel, UMI_FWD, UMI_REV, primers=primers, **kw)
    te = assign.AssignEngine(tpanel, UMI_FWD, UMI_REV, primers=primers, device="cpu", **kw)
    return je, te


def _assert_out_equal(jo: dict, to: dict):
    assert set(jo) == set(to)
    for k in jo:
        x, y = np.asarray(jo[k]), np.asarray(to[k])
        if np.issubdtype(x.dtype, np.floating):
            np.testing.assert_allclose(y, x, rtol=1e-6, equal_nan=True, err_msg=k)
        else:
            np.testing.assert_array_equal(y, x, err_msg=k)


# ---------------------------------------------------------------------------
# ops


def test_ee_filter_matches_jax():
    rng = np.random.default_rng(0)
    B, L = 64, 300
    quals = rng.integers(2, 41, (B, L)).astype(np.uint8)
    t_start = rng.integers(0, 40, B).astype(np.int32)
    t_end = (t_start + rng.integers(0, L - 40, B)).astype(np.int32)
    ee = ee_filter.expected_errors_span(_t(quals), _t(t_start), _t(t_end)).numpy()
    want = np.where(
        (np.arange(L)[None] >= t_start[:, None]) & (np.arange(L)[None] < t_end[:, None]),
        10.0 ** (-quals.astype(np.float64) / 10.0), 0.0,
    ).sum(axis=1)
    np.testing.assert_allclose(ee, want, rtol=1e-6)
    full = ee_filter.expected_errors_span(_t(quals), _t(np.zeros(B, np.int32)),
                                          _t(np.full(B, L, np.int32))).numpy()
    np.testing.assert_allclose(full, np.asarray(jee.expected_errors(quals, np.full(B, L))),
                               rtol=1e-6)
    for rate, min_len in ((0.07, 100), (0.02, 10), (0.2, 250)):
        got = ee_filter.ee_rate_mask_span(_t(quals), _t(t_start), _t(t_end), rate, min_len)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jee.ee_rate_mask_span(quals, t_start, t_end, rate, min_len))
        )


def test_kmer_profiles_are_exact(lane):
    _, jpanel, tpanel, _, _ = lane
    got = sketch.kmer_profile(_t(jpanel.codes), _t(jpanel.lens))
    np.testing.assert_array_equal(got.numpy(), jpanel.profiles)
    for k, dim in ((4, None), (8, 4096)):
        want = jsketch.kmer_profile(jpanel.codes, jpanel.lens, k=k, dim=dim)
        got = sketch.kmer_profile(_t(jpanel.codes), _t(jpanel.lens), k=k, dim=dim)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_k_keeps_jax_tie_order():
    rng = np.random.default_rng(1)
    scores = rng.integers(0, 4, (32, 40)).astype(np.float32)  # many exact ties
    for k in (1, 2, 5, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(scores), k)
        tv, ti = sketch.top_k(_t(scores), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    q = rng.integers(0, 3, (16, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        sketch.top_candidates(_t(q), _t(q), 9).numpy(),
        np.asarray(jsketch.top_candidates(q, q, 9)),
    )


def test_candidates_both_strands_match_jax(lane):
    lib, jpanel, _, _, _ = lane
    codes, lens = jencode.encode_batch([s for _, s, _ in lib.reads], pad_to=1024)
    j_idx, j_sc, j_rev = jsketch.candidates_both_strands(codes, lens, jpanel.profiles, top_k=2)
    t_idx, t_sc, t_rev = sketch.candidates_both_strands(_t(codes), _t(lens), _t(jpanel.profiles),
                                                        top_k_=2)
    j_sc = np.asarray(j_sc)
    np.testing.assert_allclose(t_sc.numpy(), j_sc, atol=COS_ATOL)
    np.testing.assert_array_equal(t_rev.numpy(), np.asarray(j_rev))
    clear = (j_sc[:, 0] - j_sc[:, 1]) > COS_ATOL
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(t_idx.numpy()[clear], np.asarray(j_idx)[clear])
    np.testing.assert_array_equal(
        sketch.revcomp_batch(_t(codes), _t(lens)).numpy(),
        np.asarray(jsketch.revcomp_batch(codes, lens)),
    )


def _fuzzy_inputs(seed: int):
    rng = np.random.default_rng(seed)
    pats = [UMI_FWD, UMI_REV, "ACGTRYACGT", "GGGNNNCC"]
    texts = []
    for b in range(24):
        body = "".join("ACGT"[x] for x in rng.integers(0, 4, 90))
        p = jsim.instantiate_iupac(rng, pats[b % len(pats)])
        if b % 3 == 0:  # plant a pattern instance, with an edit
            pos = int(rng.integers(0, 40))
            p = p[:5] + p[6:] if b % 2 else p[:7] + "A" + p[8:]
            body = body[:pos] + p + body[pos + len(p):]
        texts.append(body[: 60 + b])
    masks, mlens = jencode.pad_batch([jencode.encode_mask(p) for p in pats], pad_value=0,
                                     multiple=1)
    windows, wlens = jencode.pad_batch([jencode.encode_mask(t) for t in texts], pad_value=0,
                                       multiple=1)
    return masks, mlens, windows, wlens


@pytest.mark.parametrize("seed", (0, 1))
def test_fuzzy_find_multi_matches_jax(seed):
    masks, mlens, windows, wlens = _fuzzy_inputs(seed)
    want = jfuzzy.fuzzy_find_multi(masks, mlens, windows, wlens)
    got = fuzzy_match.fuzzy_find_multi(_t(masks), _t(mlens), _t(windows), _t(wlens))
    for name, g, w in zip(("dist", "start", "end"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_fuzzy_find_single_matches_jax():
    _, _, windows, wlens = _fuzzy_inputs(2)
    pm = jencode.encode_mask(UMI_FWD)
    want = jfuzzy.fuzzy_find(pm, windows, wlens)
    got = fuzzy_match.fuzzy_find(_t(pm), _t(windows), _t(wlens))
    for name, g, w in zip(("dist", "start", "end"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_self_homology_map_matches_jax(lane):
    lib = lane[0]
    want = jregions.self_homology_map(lib.reference, 0.93)
    got = regions.self_homology_map(lib.reference, 0.93, device="cpu")
    assert got.region_cluster == want.region_cluster
    assert got.max_blast_id == want.max_blast_id
    assert got.most_similar == want.most_similar
    assert got.stats == want.stats
    assert got.max_blast_id is not None  # the near-duplicate pair aligned


# ---------------------------------------------------------------------------
# the device passes and the store


def _batches(lane, width=1024, batch_size=32):
    lib = lane[0]
    recs = [fastx.FastxRecord(h.split()[0], " ".join(h.split()[1:]), s, q)
            for h, s, q in lib.reads]
    return list(bucketing.batch_reads(iter(recs), batch_size=batch_size, widths=(width,)))


@pytest.mark.parametrize("overlap_frac", (0.95, None))
def test_fused_pass_matches_jax(lane, overlap_frac):
    """``overlap_frac`` arms the round-1 SW fast path; None runs full SW
    with the margin-pruned second candidate."""
    je, te = _engines(lane)
    for batch in _batches(lane)[:1]:
        jo = je.run_batch(batch, 0.07, 500, overlap_frac=overlap_frac)
        to = te.run_batch(batch, 0.07, 500, overlap_frac=overlap_frac)
        _assert_out_equal(jo, to)
        assert to["sw_done"].any()


def test_targeted_pass_matches_jax(lane):
    lib, jpanel, _, _, _ = lane
    je, te = _engines(lane)
    batch = _batches(lane)[0]
    rng = np.random.default_rng(3)
    R = len(jpanel.names)
    cand = np.full((len(batch.ids), 2), -1, np.int32)
    for row in range(len(batch.ids)):
        k = int(rng.integers(1, 3))
        cand[row, :k] = rng.choice(R, size=k, replace=False)
    jo = jax.device_get(je.run_batch_targeted_async(batch, cand, 1))
    to = te.run_batch_targeted(batch, cand, 1)
    _assert_out_equal(jo, to)


def test_run_assign_store_and_stats_match_jax(lane):
    _, _, _, path, _ = lane
    je, te = _engines(lane)
    kw = dict(max_ee_rate=0.07, min_len=500, minimal_region_overlap=0.95,
              max_softclip_5_end=81, max_softclip_3_end=76, batch_size=32)
    jstore, jstats = jassign.run_assign(str(path), je, **kw)
    tstore, tstats = assign.run_assign(str(path), te, **kw)
    for f in dataclasses.fields(tstats):
        got, want = getattr(tstats, f.name), getattr(jstats, f.name)
        if dataclasses.is_dataclass(got):  # the read-length QC aggregates
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert tstats.pre_filter.n == tstats.n_total and tstats.post_filter.n == tstats.n_pass
    assert tstats.n_pass > 0
    assert len(tstore.blocks) == len(jstore.blocks)
    for jb, tb in zip(jstore.blocks, tstore.blocks):
        assert tb.width == jb.width and tb.names == jb.names
        for f in ("codes", "lens", "is_rev", "region_idx", "ref_start", "ref_end", "quals",
                  "sw_done"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f)
        np.testing.assert_allclose(tb.blast_id, jb.blast_id, rtol=1e-6, equal_nan=True)
        for k in jb.umi:
            np.testing.assert_array_equal(tb.umi[k], jb.umi[k], err_msg=k)


def test_panel_from_numpy_equals_a_panel_built_by_the_port(lane):
    lib, jpanel, tpanel, _, _ = lane
    built = assign.ReferencePanel.build(lib.reference, jpanel.region_cluster, device="cpu")
    for f in ("names", "seqs", "region_cluster"):
        assert getattr(built, f) == getattr(tpanel, f)
    for f in ("codes", "lens", "profiles", "cluster_of_region"):
        np.testing.assert_array_equal(getattr(built, f), getattr(tpanel, f), err_msg=f)
    assert encode.decode_batch(tpanel.codes, tpanel.lens) == [lib.reference[n] for n in tpanel.names]
