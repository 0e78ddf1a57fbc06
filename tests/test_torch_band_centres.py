"""Off-diagonal band centres through the pileup: the JAX package's
``pileup_columns`` with ``diag_offsets`` in {-40, -7, 0, 5, 37} against the
port's (the plain forward and traceback, the twins of kernels B2 and B3)
at W = 64 and 128, on all five outputs, spans included; the forward's best
cells and packed planes against JAX's ``_forward_banded`` at those offsets;
kernel B3's walk (the scalar model of ``tests/test_torch_traceback_kernel.py``)
at those offsets, and the mutation that drops the offset from the step's
column caught; ``pileup_columns_batch_auto`` with (C, S) offsets, split
over two CPU slices, and its route to the kernels with the offsets. Lanes:
reads whose true diagonal is the given offset (the band start reads past
either end of the draft), reads at diagonal 0 under a nonzero offset,
unrelated and empty reads, N bases (``io/dp_cases.band_centre_cluster``);
out_len below the draft width at W = 128. On a card, kernels B2 and B3 at nonzero offsets against the CPU.
Tolerance: exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu_torch.io.dp_cases import BAND_CENTRES as OFFSETS  # noqa: E402
from ont_tcrconsensus_tpu_torch.io.dp_cases import band_centre_cluster  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import pileup, pileup_kernel, traceback_kernel  # noqa: E402
from ont_tcrconsensus_tpu_torch.parallel import mesh  # noqa: E402
from test_torch_traceback_kernel import COLUMNS, _kernel_walk  # noqa: E402

try:  # the JAX reference; a card machine without JAX runs the gpu case only
    import jax
    import jax.numpy as jnp

    from ont_tcrconsensus_tpu.ops import pileup as jpileup
    from ont_tcrconsensus_tpu.ops import sw_align as jsw
except ImportError:
    jpileup = None

L = 192
SHAPES = {64: L, 128: 3 * L // 4}  # band width -> out_len


def _cluster(seed: int, S: int = 30):
    return band_centre_cluster(seed, S, L)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("W", sorted(SHAPES))
def test_pileup_columns_with_offsets_equals_jax(W):
    out_len = SHAPES[W]
    sub, lens, draft, dlen, offs = _cluster(W)
    got = pileup.pileup_columns(sub, lens, draft, dlen, offs, band_width=W, out_len=out_len,
                                device="cpu")
    want = jpileup.pileup_columns(sub, lens, jnp.asarray(draft), jnp.int32(dlen), offs,
                                  band_width=W, out_len=out_len)
    for name, g, w in zip(COLUMNS, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    base_at, spans = got[0].numpy(), got[4].numpy()
    # the lanes reach what they are there for: at offset -40 the first ~40
    # read rows lie over draft columns below 0, alignments run past out_len
    # where it is below the draft's length, and every offset's lanes align
    assert (spans[offs == -40, 0] >= 39).sum() >= 2
    assert (spans[:, 3] > out_len).any() == (out_len < dlen)
    for off in OFFSETS:
        assert (base_at[offs == off] < 4).sum() > 100, off


@pytest.mark.parametrize("W", (64,))
def test_forward_planes_with_offsets_equal_jax(W):
    sub, lens, draft, dlen, offs = _cluster(11)
    drafts = np.repeat(draft[None], len(sub), axis=0)
    dlens = np.full(len(sub), dlen, np.int32)
    best, planes = pileup._forward_batch(_t(sub), _t(lens), _t(drafts), _t(dlens), W,
                                         offs=_t(offs))
    scoring = (jsw.MATCH, jsw.MISMATCH, jsw.GAP_OPEN, jsw.GAP_EXT)

    @jax.jit
    def forward(r, rl, d, dl, o):
        def one(read, rlen, ref, tlen, off):
            b, tdir, fjump = jpileup._forward_banded(read, rlen, ref, tlen, off, W, scoring)
            return b, tdir.astype(jnp.uint16) | (fjump.astype(jnp.uint16) << 4)
        return jax.vmap(one)(r, rl, d, dl, o)

    jbest, jplanes = forward(sub, lens, drafts, dlens, offs)
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    np.testing.assert_array_equal(planes.numpy().astype(np.uint16), np.asarray(jplanes))


def test_b3_walk_with_offsets_equals_jax_and_a_dropped_offset_is_caught():
    """Kernel B3's walk at the lanes' offsets equals the plain steps and
    JAX's columns; with the offset left out of the step's column (the chunk
    start keeping it) the columns differ."""
    W, out_len = 128, SHAPES[128]
    sub, lens, draft, dlen, offs = _cluster(128)
    drafts = np.repeat(draft[None], len(sub), axis=0)
    dlens = np.full(len(sub), dlen, np.int32)
    best, planes = pileup._forward_batch(_t(sub), _t(lens), _t(drafts), _t(dlens), W,
                                         offs=_t(offs))
    plain = pileup._traceback_batch(best, planes, _t(sub), W, out_len, offs=_t(offs))
    want = jpileup.pileup_columns(sub, lens, jnp.asarray(draft), jnp.int32(dlen), offs,
                                  band_width=W, out_len=out_len)
    u16 = planes.numpy().astype(np.uint16)
    got = _kernel_walk(best.numpy(), u16, sub, W, out_len, offs=offs)
    for name, g, p, w in zip(COLUMNS, got, plain, want):
        np.testing.assert_array_equal(p.numpy(), np.asarray(w), err_msg=f"plain {name}")
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"walk {name}")
    mutated = _kernel_walk(best.numpy(), u16, sub, W, out_len, offs=offs, jrow_offset=False)
    assert not np.array_equal(mutated[0], got[0])


def test_batch_with_offsets_per_cluster_split_and_routed(monkeypatch):
    """(C, S) offsets through ``pileup_columns_batch_auto``: each cluster's
    columns = its own ``pileup_columns``; split over two CPU slices =
    unsplit; no offsets = zero offsets; and for tensors off the CPU the
    offsets reach both kernels' wrappers, None when none are given."""
    W, out_len = 64, L
    clusters = [_cluster(seed, S=10) for seed in (21, 22)]
    sub, lens, drafts, dlens, offs = (np.stack([c[k] for c in clusters]) for k in range(5))
    args = [_t(x) for x in (sub, lens, drafts, dlens)]
    got = pileup.pileup_columns_batch_auto(*args, band_width=W, out_len=out_len,
                                           diag_offsets=_t(offs))
    for c in range(2):
        one = pileup.pileup_columns(sub[c], lens[c], drafts[c], dlens[c], offs[c],
                                    band_width=W, out_len=out_len, device="cpu")
        for g, o in zip(got, one):
            assert torch.equal(g[c], o)
    mesh.install_slice_devices(["cpu"] * 2)
    try:
        split = pileup.pileup_columns_batch_auto(*args, band_width=W, out_len=out_len,
                                                 mesh=mesh.make_mesh({"data": 2}),
                                                 diag_offsets=_t(offs))
    finally:
        mesh.install_slice_devices(None)
    for g, s in zip(got, split):
        assert torch.equal(g, s)
    zero = pileup.pileup_columns_batch_auto(*args, band_width=W, out_len=out_len,
                                            diag_offsets=torch.zeros(2, 10, dtype=torch.int32))
    for z, n in zip(zero, pileup.pileup_columns_batch_auto(*args, band_width=W,
                                                           out_len=out_len)):
        assert torch.equal(z, n)

    seen = []

    def forward(reads, rl, refs, tl, band_width, offs=None):
        seen.append(("B2", offs))
        n, width = reads.shape
        return (torch.zeros(n, 3, dtype=torch.int32, device=reads.device),
                torch.zeros(n, width, band_width, dtype=torch.int16, device=reads.device))

    def traceback(best, planes, reads, band_width, out_len, offs=None):
        seen.append(("B3", offs))
        n = reads.shape[0]
        z = torch.zeros(n, out_len, dtype=torch.int32, device=reads.device)
        return z, z, z, z, torch.zeros(n, 4, dtype=torch.int32, device=reads.device)

    monkeypatch.setattr(pileup_kernel, "forward_planes_cuda", forward)
    monkeypatch.setattr(traceback_kernel, "traceback_columns_cuda", traceback)
    meta = [a.to("meta") for a in args]
    pileup.pileup_columns_batch_auto(*meta, band_width=W, out_len=out_len,
                                     diag_offsets=_t(offs).to("meta"))
    pileup.pileup_columns_batch_auto(*meta, band_width=W, out_len=out_len)
    assert [k for k, _ in seen] == ["B2", "B3", "B2", "B3"]
    assert all(o is not None and o.shape == (20,) for _, o in seen[:2])
    assert seen[2][1] is None and seen[3][1] is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels B2 and B3 have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("W", sorted(SHAPES))
def test_kernels_with_offsets_equal_the_cpu_on_the_card(cuda_device, W):
    out_len = SHAPES[W]
    sub, lens, draft, dlen, offs = _cluster(W)
    kernels = (pileup_kernel.forward_planes_cuda, traceback_kernel.traceback_columns_cuda)
    before = [(k.launches, k.launches_offs) for k in kernels]
    got = pileup.pileup_columns(sub, lens, draft, dlen, offs, band_width=W, out_len=out_len,
                                device=cuda_device)
    # both launches counted, each as one given band centres
    assert [(k.launches - n, k.launches_offs - o)
            for k, (n, o) in zip(kernels, before)] == [(1, 1), (1, 1)]
    want = pileup.pileup_columns(sub, lens, draft, dlen, offs, band_width=W, out_len=out_len,
                                 device="cpu")
    for name, g, w in zip(COLUMNS, got, want):
        assert torch.equal(g.cpu(), w), name
