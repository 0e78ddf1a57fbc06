"""The bf16 serving gate: the PyTorch port against the JAX package.

Held to the JAX package: the A/B's float32 arm (byte-equal polished
output on the same simulated clusters, n = 4, depths (2, 4)); the bf16
network's logits, within 0.15 of JAX's bf16 logits on the served weights
(both round parameters and activations to bfloat16, 8 bits of mantissa,
through different GRU arithmetic; the logits reach ~11 and either bf16
run differs from its float32 logits by up to ~0.07),
while the two packages' bf16 mismatch counts are not compared;
``bf16_serving_certified``'s decisions on crafted artifacts. Then the two
call sites: the pipeline's polisher and the serve prewarm take bf16 only
when the gate allows it, the run logging JAX's line."""

from __future__ import annotations

import inspect
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ont_tcrconsensus_tpu.models import polisher as jpolisher  # noqa: E402
from ont_tcrconsensus_tpu.pipeline import run as jrun  # noqa: E402
from ont_tcrconsensus_tpu_torch import convert  # noqa: E402
from ont_tcrconsensus_tpu_torch.models import polisher  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import run as trun  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig  # noqa: E402
from ont_tcrconsensus_tpu_torch.serve import prewarm  # noqa: E402
from test_torch_e2e import _one_torch_thread  # noqa: E402,F401  (autouse)

ENABLED = "polisher: bf16 serving enabled (exactness A/B certified)"


def _capture(module, monkeypatch):
    """Record every polisher ``module.make_pipeline_polisher`` builds:
    (bf16, the outputs of each call)."""
    made = []
    real = module.make_pipeline_polisher

    def make(*args, **kwargs):
        inner = real(*args, **kwargs)
        rec = {"bf16": kwargs.get("bf16", False), "outs": []}
        made.append(rec)

        def polish(*a, **k):
            out = inner(*a, **k)
            rec["outs"].append(tuple(np.asarray(x).copy() for x in out))
            return out

        polish.wants_v4 = inner.wants_v4
        return polish

    monkeypatch.setattr(module, "make_pipeline_polisher", make)
    return made


def test_ab_fp32_arm_equals_jax(monkeypatch):
    kw = dict(n_clusters=4, depths=(2, 4), template_len=128, seed=17, write=False)
    got_made = _capture(polisher, monkeypatch)
    want_made = _capture(jpolisher, monkeypatch)
    got = polisher.run_bf16_exactness_ab(device="cpu", **kw)
    want = jpolisher.run_bf16_exactness_ab(**kw)
    assert [m["bf16"] for m in got_made] == [m["bf16"] for m in want_made] == [False, True]
    for g, w in zip(got_made[0]["outs"][0], want_made[0]["outs"][0]):
        np.testing.assert_array_equal(g, w)
    # the bf16 arm ran and gave a whole output (its decisions may differ)
    assert got_made[1]["outs"][0][0].shape == want_made[1]["outs"][0][0].shape
    for key in ("weights", "low_depth_weights", "min_polish_depth", "n_clusters", "depths",
                "template_len", "seed"):
        assert got[key] == want[key], key
    assert (got["backend"], got["device_kind"]) == ("cpu", "cpu") == (
        want["backend"], want["device_kind"])
    assert got["identical"] == (got["mismatched_clusters"] == 0)


def test_ab_writes_its_artifact(tmp_path):
    out = tmp_path / "ab.json"
    rec = polisher.run_bf16_exactness_ab(n_clusters=2, depths=(4,), template_len=128,
                                         out_path=str(out), device="cpu")
    with open(out) as fh:
        assert json.load(fh) == rec


@pytest.mark.parametrize("version", ("v3", "v4"))
def test_bf16_logits_near_jax_bf16(version):
    params = polisher.load_params(os.path.join(os.path.dirname(polisher.__file__), "weights",
                                               f"polisher_{version}.msgpack"))
    fdim = polisher.params_feature_dim(params)
    feats = np.random.default_rng(3).normal(size=(2, 96, fdim)).astype(np.float32)
    with torch.inference_mode():
        got = polisher.apply_logits(params, feats, bf16=True, device="cpu")
        fp32 = polisher.apply_logits(params, feats, device="cpu")
    want = np.asarray(jpolisher.apply_logits(params, jnp.asarray(feats), bf16=True))
    assert got.dtype == torch.float32 and got.shape == (2, 96, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.15)
    assert 0 < float((got - fp32).abs().max()) < 0.25


def test_the_bf16_copy_is_separate():
    model = convert.polisher_from_numpy(polisher.load_default_params(), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    feats = torch.zeros((1, 8, 15))
    with torch.inference_mode():
        polisher.apply_logits(model, feats, bf16=True)
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32
        assert torch.equal(v, before[k]), k


def _write_artifact(path, **over):
    rec = {"identical": True, "weights": "polisher_v3.msgpack",
           "low_depth_weights": "polisher_v4.msgpack", "min_polish_depth": 4,
           "device_kind": "KIND"}
    rec.update(over)
    with open(path, "w") as fh:
        json.dump(rec, fh)


def test_gate_decisions_equal_jax(tmp_path, monkeypatch):
    for module in (polisher, jpolisher):
        monkeypatch.setattr(module, "bf16_ab_artifact_path",
                            lambda backend: str(tmp_path / f"polisher_bf16_ab_{backend}.json"))
    cases = {
        "certified": {},
        "not identical": {"identical": False},
        "stale weights": {"weights": "polisher_v2.msgpack"},
        "another specialist": {"low_depth_weights": None},
        "another depth gate": {"min_polish_depth": 3},
    }
    queries = [("gpu", "KIND", 4), ("gpu", "OTHER", 4), ("gpu", None, 4), ("gpu", "KIND", 3),
               ("tpu", "KIND", 4), ("cpu", "cpu", 4)]
    seen = []
    for name, over in cases.items():
        for backend in ("gpu", "tpu", "cpu"):
            _write_artifact(tmp_path / f"polisher_bf16_ab_{backend}.json", **over)
        for q in queries:
            got = polisher.bf16_serving_certified(*q[:2], min_polish_depth=q[2])
            assert got == jpolisher.bf16_serving_certified(*q[:2], min_polish_depth=q[2]), (
                name, q)
            seen.append(got)
    assert any(seen) and not all(seen)
    (tmp_path / "polisher_bf16_ab_gpu.json").write_text("{not json")
    assert not polisher.bf16_serving_certified("gpu", "KIND")
    os.remove(tmp_path / "polisher_bf16_ab_gpu.json")
    assert not polisher.bf16_serving_certified("gpu", "KIND")


def test_gate_defaults_to_the_run_device(tmp_path, monkeypatch):
    monkeypatch.setattr(polisher, "bf16_ab_artifact_path",
                        lambda backend: str(tmp_path / f"polisher_bf16_ab_{backend}.json"))
    _write_artifact(tmp_path / "polisher_bf16_ab_cpu.json", device_kind="cpu")
    assert not polisher.bf16_serving_certified(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "KIND")
    assert polisher._backend_of(None) == ("gpu", "KIND")
    _write_artifact(tmp_path / "polisher_bf16_ab_gpu.json")
    assert polisher.bf16_serving_certified()
    assert polisher.bf16_serving_certified(device="cuda:0")
    assert not polisher.bf16_serving_certified(device="cpu")


def test_shipped_tree_has_no_certificate():
    weights = os.path.join(os.path.dirname(polisher.__file__), "weights")
    assert not [f for f in os.listdir(weights) if f.startswith("polisher_bf16_ab")]
    assert os.path.dirname(polisher.bf16_ab_artifact_path("gpu")) == weights
    assert polisher._current_low_depth_basename() == jpolisher._current_low_depth_basename()


@pytest.mark.parametrize("certified", (False, True))
def test_run_and_prewarm_follow_the_gate(certified, monkeypatch, capsys, tmp_path):
    asked = []

    def gate(min_polish_depth=4, device=None, **_):
        asked.append((min_polish_depth, device))
        return certified

    monkeypatch.setattr(polisher, "bf16_serving_certified", gate)
    made = _capture(polisher, monkeypatch)
    cfg = RunConfig(reference_file="r.fa", fastq_pass_dir=str(tmp_path), min_polish_depth=5,
                    cluster_batch_size=2, max_reads_per_cluster=4)
    trun._rnn_polisher(cfg, torch.device("cpu"))
    err = capsys.readouterr().err
    assert (ENABLED in err) == certified
    assert "float32" not in err
    # the JAX package logs the same line
    assert f'_log("{ENABLED}")' in inspect.getsource(jrun)
    panel = SimpleNamespace(names=["a"], lens=np.array([200], np.int32),
                            codes=np.random.default_rng(0).integers(0, 4, (1, 256)).astype(np.uint8))
    report = []
    prewarm._prewarm_polisher(cfg, SimpleNamespace(panel=panel, device=torch.device("cpu")),
                              None, [256], report)
    assert report[0]["ok"], report
    assert [m["bf16"] for m in made] == [certified, certified]
    assert asked == [(5, torch.device("cpu"))] * 2
    off = RunConfig(reference_file="r.fa", fastq_pass_dir=str(tmp_path), polish_bf16=False)
    trun._rnn_polisher(off, torch.device("cpu"))
    assert made[-1]["bf16"] is False and len(asked) == 2
