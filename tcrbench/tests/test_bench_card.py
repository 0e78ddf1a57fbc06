"""On a card: one tiny run of each cell through the kernels, judged
correct, with its traced per-layer metrics. Skips without a card."""

import os

import pytest

from tcrbench import run
from tcrbench.tests._tiny import TINY

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["rnn.deep_lane", "poa.clonal_lane"])
def test_tiny_run_on_the_card(cell, tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    r = run.run_cell(cell, 11, 0.1, True, root=ROOT, device="cuda", traffic=TINY,
                     work=str(tmp_path / "work"))
    assert r["correct"] is True, r["check"]
    assert r["device"]["busy_s"] > 0 and "device.idle_share" in r["metrics"]
