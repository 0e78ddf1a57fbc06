"""Every public entry point of the port runs on the card when given no
device, and raises ``no CUDA device`` where there is none: a library caller
who names no device never lands on the CPU without noticing."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu_torch import convert  # noqa: E402
from ont_tcrconsensus_tpu_torch.cluster import regions, umi  # noqa: E402
from ont_tcrconsensus_tpu_torch.device import resolve_device  # noqa: E402
from ont_tcrconsensus_tpu_torch.models import polisher, train  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import consensus, pileup  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import assign, stages  # noqa: E402

REFERENCE = {"r0": "ACGTACGTTGCA" * 20, "r1": "TTGCAACGTACG" * 20}
UMI = "TTTVVTTVVVVTTT"


def _cpu_panel():
    return assign.ReferencePanel.build(REFERENCE, {"r0": 0, "r1": 1}, device="cpu")


ENTRY_POINTS = {
    "consensus_clusters_batch": lambda: consensus.consensus_clusters_batch(
        np.zeros((1, 2, 128), np.uint8), np.full((1, 2), 100, np.int32)),
    "polish_clusters_all": lambda: stages.polish_clusters_all([], assign.ReadStore([])),
    "cluster_and_select_grouped": lambda: stages.cluster_and_select_grouped(
        [], identity=0.93, min_umi_length=1, max_umi_length=100, min_reads_per_cluster=1,
        max_reads_per_cluster=8, balance_strands=False),
    "self_homology_map": lambda: regions.self_homology_map(REFERENCE, 0.93),
    "cluster_umis": lambda: umi.cluster_umis(["ACGT", "ACGA"], 0.9),
    "cluster_umis_grouped": lambda: umi.cluster_umis_grouped([["ACGT"]], 0.9),
    "ReferencePanel.build": lambda: assign.ReferencePanel.build(REFERENCE, {"r0": 0, "r1": 1}),
    "AssignEngine": lambda: assign.AssignEngine(_cpu_panel(), UMI, UMI),
    "panel_from_numpy": lambda: convert.panel_from_numpy(
        *(lambda p: (p.codes, p.lens, p.profiles, p.names, p.region_cluster))(_cpu_panel())),
    "polisher_from_numpy": lambda: convert.polisher_from_numpy(polisher.load_default_params()),
    "make_pipeline_polisher": lambda: polisher.make_pipeline_polisher(
        polisher.load_default_params()),
    "consensus_cluster": lambda: consensus.consensus_cluster(
        np.zeros((2, 128), np.uint8), np.full(2, 100, np.int32)),
    "pileup_columns": lambda: pileup.pileup_columns(
        np.zeros((2, 128), np.uint8), np.full(2, 100, np.int32), np.zeros(128, np.uint8), 100,
        np.zeros(2, np.int32)),
    "apply_logits": lambda: polisher.apply_logits(polisher.load_default_params(),
                                                  np.zeros((1, 8, 15), np.float32)),
    "polish_draft": lambda: polisher.polish_draft(
        polisher.load_default_params(), np.zeros((8, 15), np.float32), np.zeros(8, np.uint8), 8),
    "trainable": lambda: polisher.trainable(polisher.load_default_params()),
    "run_bf16_exactness_ab": lambda: polisher.run_bf16_exactness_ab(n_clusters=1, write=False),
    "make_examples": lambda: train.make_examples(0, 1),
    "train": lambda: train.train(steps=1, pool_examples=1),
    "evaluate_consensus_gain": lambda: train.evaluate_consensus_gain(
        polisher.load_default_params(), n_clusters=1),
    "evaluate_accuracy": lambda: train.evaluate_accuracy(polisher.load_default_params()),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_no_device_means_the_card_and_raises_without_one(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_no_device_resolves_to_cuda_with_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
