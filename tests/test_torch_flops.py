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
    for key in ("exp_per_s", "elem_per_s", "fp32_tflops", "tf32_tflops", "bf16_tflops",
                "hbm_gbps"):
        assert np.isfinite(rates[key]) and rates[key] > 0, key
    # a second call at the same scale reads the cache, keyed by name, power
    # limit and scale
    assert roofline.measure_device_rates(use_cache=True, scale=64, device="cpu") == rates
    assert "cpu|None|scale=64" in open(tmp_path / "roofline.json").read()
    # a default (scale 1) call never takes the scaled plumbing run as the
    # device's rates (step_ceiling(rates=None) makes such a call): it measures
    full = dict(rates, exp_per_s=1.0, tf32_tflops=1.0)
    full.pop("device_kind"), full.pop("power_limit_w")
    seen = []
    monkeypatch.setattr(roofline, "_cpu_rates", lambda scale: seen.append(scale) or dict(full))
    assert roofline.measure_device_rates(use_cache=True, device="cpu")["exp_per_s"] == 1.0
    assert roofline.measure_device_rates(use_cache=True, device="cpu")["exp_per_s"] == 1.0
    assert seen == [1]
    assert roofline.measure_device_rates(use_cache=True, scale=64, device="cpu") == rates


def test_torch_bf16_peak_and_operations_count():
    """The dense BF16 rate of the H100 SXM (989 TFLOP/s), and a kernel's least
    time of operations: its products three TF32 passes at the TF32 rate in
    f32, once at the BF16 rate in the bf16 operand mode, the CUDA-core FLOPs
    at the FP32 rate either way; at the published rates or at measured ones.
    The QM9 forward (B=128, M=32, N=16, L=7, D=128) as the bound of kernel #1
    in each mode."""
    from scann_tpu_torch.config import ModelConfig
    from scann_tpu_torch.kernels import scann_forward as kfwd

    name = "NVIDIA H100 80GB HBM3"
    assert flops.peak_bf16_tflops(name) == 989.0
    assert flops.peak_bf16_tflops("NVIDIA A100-SXM4-80GB") is None
    f, f32 = 3.0e12, 1.0e11
    assert flops.operations_seconds(f, f32, device_name=name) == pytest.approx(
        3 * (f - f32) / 495e12 + f32 / 67e12, rel=1e-12)
    assert flops.operations_seconds(f, f32, bf16=True, device_name=name) == pytest.approx(
        (f - f32) / 989e12 + f32 / 67e12, rel=1e-12)
    rates = dict(RATES, bf16_tflops=700.0)
    assert flops.operations_seconds(f, f32, bf16=True, rates=rates) == pytest.approx(
        (f - f32) / 700e12 + f32 / 66e12, rel=1e-12)
    assert flops.operations_seconds(f, 0.0, rates=rates) == pytest.approx(3 * f / 330e12)
    qm9 = ModelConfig(n_atoms=10, embedding_dim=48, n_attention=7)
    work = kfwd.forward_flops(qm9, 128, 32, 16), kfwd.forward_fp32_flops(qm9, 128, 32, 16)
    f32_ms = 1e3 * flops.operations_seconds(*work, device_name=name)
    bf16_ms = 1e3 * flops.operations_seconds(*work, bf16=True, device_name=name)
    assert f32_ms == pytest.approx(0.31, abs=0.01)
    assert bf16_ms == pytest.approx(0.0541, abs=1e-4)     # 5.99x less product time


def test_torch_bf16_backward_bounds_count_products_once():
    """The bounds of the bf16 rows of the backward kernels (chip_smoke phase
    15): #2 at QM9 (B=128, M=32, N=16, L=7) and #4 at MP2018 (B=64, M=96,
    N=32, L=9) keep the counts of their f32 rows (``backward_flops``,
    ``loop_backward_flops``, ``backward_fp32_flops``) and take the products
    once at the dense 989 TFLOP/s BF16 where f32 takes three TF32 passes at
    495, the energies, softmax and LayerNorm work at 67 TFLOP/s FP32 in both."""
    from scann_tpu_torch.config import ModelConfig
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_loop as kloop

    name = "NVIDIA H100 80GB HBM3"
    qm9 = ModelConfig(n_atoms=10, embedding_dim=48, n_attention=7)
    mp = ModelConfig(n_atoms=95, embedding_dim=128, n_attention=9, gaussian_d=6.0)
    for f, f32, lo, hi in (
            (kbwd.backward_flops(qm9, 128, 32, 16), kbwd.backward_fp32_flops(qm9, 128, 32, 16),
             1.45e11, 1.55e11),
            (kloop.loop_backward_flops(mp, 64, 96, 32), kbwd.backward_fp32_flops(mp, 64, 96, 32),
             5.4e11, 5.6e11)):
        assert lo < f < hi and 0 < f32 < f
        bf16 = flops.operations_seconds(f, f32, bf16=True, device_name=name)
        assert bf16 == pytest.approx((f - f32) / 989e12 + f32 / 67e12, rel=1e-12)
        assert flops.operations_seconds(f, f32, device_name=name) == pytest.approx(
            3 * (f - f32) / 495e12 + f32 / 67e12, rel=1e-12)
    bound_ms = lambda cfm, *shape: 1e3 * flops.operations_seconds(
        kbwd.backward_flops(cfm, *shape), kbwd.backward_fp32_flops(cfm, *shape), bf16=True,
        device_name=name)
    assert bound_ms(qm9, 128, 32, 16) == pytest.approx(0.1618, abs=1e-4)   # f32: 0.9155
    assert bound_ms(mp, 64, 96, 32) == pytest.approx(0.5970, abs=1e-4)     # f32: 3.3744
