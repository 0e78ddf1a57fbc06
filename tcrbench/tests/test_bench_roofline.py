"""The kernels' count functions on shapes worked by hand."""

import os

import pytest
import torch

from tcrbench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def kernels():
    return run.LaunchRecorder(ROOT).kernels


def _n(x):
    return int(x.item()) if torch.is_tensor(x) else int(x)


def test_sw_banded(kernels):
    k = kernels["sw_banded_kernel"]
    reads = torch.zeros((2, 4), dtype=torch.uint8)
    refs = torch.zeros((2, 6), dtype=torch.uint8)
    ops, nbytes = k.count((reads, torch.tensor([3, 9]), refs, torch.tensor([6, 6]),
                           torch.zeros(2)), {"band_width": 128}, None)
    # rows 3 + 4 (clamped to L), 128 cells a row, 68 ops a cell
    assert _n(ops) == 7 * 128 * 68
    assert _n(nbytes) == 7 + 2 * 6 + 24 + 56


def test_pileup_forward(kernels):
    k = kernels["pileup_forward_kernel"]
    reads = torch.zeros((2, 4), dtype=torch.uint8)
    ops, nbytes = k.count((reads, torch.tensor([2, 4]), torch.zeros((2, 5)), torch.tensor([5, 5]),
                           64), {}, None)
    # DP rows: 3 and 4 (the row after a read's end, clamped); 1 padded row
    assert _n(ops) == 7 * 64 * 45 + 1 * 64 * 9
    assert _n(nbytes) == 8 + 10 + 16 + 24 + 2 * 2 * 4 * 64


def test_pileup_traceback_and_error_profile(kernels):
    tb = kernels["pileup_traceback_kernel"]
    planes = torch.zeros((2, 4, 64), dtype=torch.int16)
    # spans [read start, read end, draft start, draft end): walks of at
    # least 3 and 4 cells (the longer span), reading 3 and 2 read bases
    spans = torch.tensor([[0, 3, 1, 3], [1, 3, 0, 4]], dtype=torch.int32)
    ops, nbytes = tb.count((torch.zeros((2, 3)), planes, torch.zeros((2, 4)), 64, 5), {},
                           (None, None, None, None, spans))
    assert ops == 0 and _n(nbytes) == 24 + (3 + 4) * 2 + (3 + 2) + 2 * 5 * 10 + 32
    cs = kernels["error_profile_cs_kernel"]
    L, N, M = 3, 2, 5
    args = (torch.zeros((L, N), dtype=torch.uint8), torch.zeros((L, M), dtype=torch.uint8),
            torch.zeros(L), torch.zeros(L), torch.zeros((L, N + 1)), torch.zeros(L), 128)
    ops, nbytes = cs.count(args, {}, None)
    assert ops == 0 and nbytes == L * N + L * M + 4 * (3 * L + L * (N + 1)) + 3 * (N + M) * L


def test_fuzzy_match(kernels):
    k = kernels["fuzzy_match_kernel"]
    pm = torch.zeros((2, 70), dtype=torch.uint8)
    plens = torch.tensor([32, 70])          # 1 and 2 words
    windows = torch.zeros((3, 10), dtype=torch.uint8)
    wlens = torch.tensor([10, 4, 12])       # 10, 4, 10 columns
    end = torch.tensor([[3, 0, 10], [5, 4, 1]])
    ops, nbytes = k.count((pm, plens, windows, wlens), {}, (None, None, end))
    cols = 10 + 4 + 10
    steps = 1 * cols + 2 * cols + (1 * 13 + 2 * 10)
    assert _n(ops) == steps * 20 + cols * 2 * 7 + 23 * 6
    assert _n(nbytes) == (32 + 70) + 8 + cols + 12 + 3 * 4 * 2 * 3


def test_dovetail_pairs_and_grid(kernels):
    k = kernels["dovetail_kernel"]
    a = torch.zeros((2, 128), dtype=torch.uint8)
    al, bl = torch.tensor([64, 65]), torch.tensor([60, 10])
    ops, nbytes = k.count((a, al, a, bl, 2, 0, 8), {}, None)
    steps = 1 * 60 + 2 * 10
    top = (60 - 52) + (10 - 2)
    left = (64 - 56) + (65 - 57)
    assert _n(ops) == steps * 20 + top * 5 + left * 4
    assert _n(nbytes) == (64 + 65) + (60 + 10) + 16 + 8
    ops, _ = k.count((a, al, a, bl, 4, 2, 0), {}, None)
    assert _n(ops) == (1 * 60 + 1 * 10 + 2 * 60 + 2 * 10) * 20
