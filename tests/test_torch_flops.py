"""The port's FLOP, operation, byte and parameter counts (``utils/flops.py``)
against the JAX package's, its published H100 rates, the step ceiling of
``utils/roofline.py`` and the CPU run of ``measure_device_rates``."""

import os

import numpy as np
import pytest
import torch

from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.config import load_config as jax_load_config
from scann_tpu.utils import flops as jax_flops
from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.config import load_config
from scann_tpu_torch.models.scann import init_params
from scann_tpu_torch.utils import flops, roofline

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the three cases of tests/test_flops.py: (model fields, B, M, N)
CASES = {
    "qm9": (dict(n_atoms=95, embedding_dim=128, n_attention=7, local_dim=128, num_head=8,
                 global_dim=128, dense_out=128, g_update=True), 16, 32, 16),
    "mp": (dict(n_atoms=95, embedding_dim=128, n_attention=9, local_dim=128, num_head=8,
                global_dim=128, dense_out=128, g_update=True, gaussian_d=6.0), 4, 96, 32),
    "small": (dict(n_atoms=95, embedding_dim=64, n_attention=3, local_dim=64, num_head=8,
                   global_dim=64, dense_out=32, g_update=False), 8, 24, 8),
}
CONFIGS = {"model_qm9": (128, 32, 16), "model_mp2018": (64, 96, 32), "model_ptgp": (64, 128, 32)}


def _models(name):
    """(port ModelConfig, JAX ModelConfig, B, M, N) of a case or a config file,
    each loaded by its own package."""
    if name in CASES:
        kw, B, M, N = CASES[name]
        return ModelConfig(**kw), JaxModelConfig(**kw), B, M, N
    path = os.path.join(ROOT, "configs", f"{name}.yaml")
    return (load_config(path).model, jax_load_config(path).model) + CONFIGS[name]


ALL = sorted(CASES) + sorted(CONFIGS)


@pytest.mark.parametrize("name", ALL)
def test_torch_counts_equal_the_jax_package(name):
    cfm, jcfm, B, M, N = _models(name)
    assert flops.forward_flops_per_structure(cfm, M, N) == \
        jax_flops.forward_flops_per_structure(jcfm, M, N)
    assert flops.train_flops_per_structure(cfm, M, N) == \
        jax_flops.train_flops_per_structure(jcfm, M, N)
    for training in (True, False):
        assert flops.gather_flops_per_structure(cfm, M, N, training) == \
            jax_flops.gather_flops_per_structure(jcfm, M, N, training)
        assert flops.vpu_costs_per_structure(cfm, M, N, training) == \
            jax_flops.vpu_costs_per_structure(jcfm, M, N, training)
        assert flops.hbm_bytes_per_structure(cfm, M, N, B, training) == \
            jax_flops.hbm_bytes_per_structure(jcfm, M, N, B, training)
    assert flops._param_count(cfm) == jax_flops._param_count(jcfm)


@pytest.mark.parametrize("name", ALL)
def test_torch_param_count_matches_the_port_model(name):
    """``_param_count`` is the port model's parameter count, but for the ring
    embedding that the JAX formula leaves out (``extra_embed`` 2 -> 10 and
    the 10 extra input rows of ``dense_embed``)."""
    cfm, _, _, _, _ = _models(name)
    params = init_params(cfm, torch.Generator().manual_seed(0), "cpu")
    real = sum(p.numel() for p in params.values())
    ring = (2 * 10 + 10 + 10 * cfm.local_dim) if cfm.use_ring else 0
    assert real == flops._param_count(cfm) + ring


def test_torch_peaks_of_the_h100():
    name = "NVIDIA H100 80GB HBM3"
    assert flops.peak_tflops(name) == 495.0
    assert flops.peak_fp32_tflops(name) == 67.0
    assert flops.peak_hbm_bytes_s(name) == 3.35e12
    # 16 special-function results against 128 FMAs a clock an SM
    assert flops.peak_exp_per_s(name) == pytest.approx(67e12 / 256 * 16)
    for other in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "TPU v5 lite"):
        assert flops.peak_tflops(other) is None
        assert flops.peak_fp32_tflops(other) is None
        assert flops.peak_hbm_bytes_s(other) is None
        assert flops.peak_exp_per_s(other) is None


# rates of the order an H100 SXM gives (fixed, so the test is exact)
RATES = {"device_kind": "NVIDIA H100 80GB HBM3", "exp_per_s": 3.6e12, "elem_per_s": 3.3e13,
         "fp32_tflops": 66.0, "tf32_tflops": 330.0, "hbm_gbps": 2800.0}


@pytest.mark.parametrize("name", ["model_qm9", "model_mp2018", "small"])
@pytest.mark.parametrize("training", [True, False])
def test_torch_step_ceiling_is_ordered(name, training):
    cfm, _, B, M, N = _models(name)
    c = roofline.step_ceiling(cfm, M, N, B, rates=RATES, training=training)
    ts = {"tensor": c["t_tensor_us"], "cuda_cores": c["t_cuda_cores_us"], "hbm": c["t_hbm_us"]}
    assert all(t > 0 for t in ts.values())
    assert c["binding_engine"] == max(ts, key=ts.get)
    assert c["structs_per_s"] == pytest.approx(1e6 / max(ts.values()), rel=1e-12)
    assert c["structs_per_s_serial"] == pytest.approx(1e6 / sum(ts.values()), rel=1e-12)
    assert 0 < c["structs_per_s_serial"] <= c["structs_per_s"]
    assert 0 < c["mfu_serial"] <= c["mfu_ceiling"] < 1.0
    # the products as three TF32 passes; the gather is not charged
    useful = (flops.train_flops_per_structure if training
              else flops.forward_flops_per_structure)(cfm, M, N)
    assert c["useful_flops_per_structure"] == useful
    assert c["tensor_flops_per_structure"] == 3 * useful
    assert c["t_tensor_us"] == pytest.approx(3 * useful / 330e12 * 1e6, rel=1e-12)
    assert c["mfu_ceiling"] == pytest.approx(c["structs_per_s"] * useful / 495e12, rel=1e-12)


def test_torch_stash_all_is_at_least_as_fast_and_a_bad_schedule_raises():
    cfm, _, B, M, N = _models("model_mp2018")
    keep = roofline.step_ceiling(cfm, M, N, B, rates=RATES, schedule="keep_acts")
    stash = roofline.step_ceiling(cfm, M, N, B, rates=RATES, schedule="stash_all")
    assert stash["transcendentals_per_structure"] == keep["transcendentals_per_structure"] / 2
    assert stash["structs_per_s"] >= keep["structs_per_s"]
    assert stash["structs_per_s_serial"] > keep["structs_per_s_serial"]
    with pytest.raises(ValueError, match="unknown schedule"):
        roofline.step_ceiling(cfm, M, N, B, rates=RATES, schedule="bogus")
    # a card not in the peak table has no MFU, the rest stands
    other = roofline.step_ceiling(cfm, M, N, B, rates=dict(RATES, device_kind="cpu"))
    assert other["mfu_ceiling"] is None and other["structs_per_s"] == keep["structs_per_s"]


def test_torch_measure_device_rates_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(roofline, "_CACHE_PATH", str(tmp_path / "roofline.json"))
    rates = roofline.measure_device_rates(use_cache=False, scale=64, device="cpu")
    assert rates["device_kind"] == "cpu"
    assert rates["power_limit_w"] is None and rates["sm_clock_mhz"] is None
    for key in ("exp_per_s", "elem_per_s", "fp32_tflops", "tf32_tflops", "hbm_gbps"):
        assert np.isfinite(rates[key]) and rates[key] > 0, key
    # the second call reads the cache, keyed by name and power limit
    assert roofline.measure_device_rates(use_cache=True, device="cpu") == rates
    assert "cpu|None" in open(tmp_path / "roofline.json").read()
