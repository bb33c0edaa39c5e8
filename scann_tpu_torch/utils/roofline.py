"""The card's measured rates and a step-time ceiling (port of
``scann_tpu/utils/roofline.py``).

1. ``measure_device_rates()`` times this card's achievable rates, not the
   data sheet's: ``expf`` results/s and FP32 FMAs/s on the CUDA cores,
   TF32 and BF16 ``mma.sync`` TFLOP/s on the tensor cores, and HBM bytes/s, from
   the probes of ``csrc/roofline_probe.cu`` (dependent chains, so neither
   launches nor memory can pass for compute). Each rate is a two-depth
   difference: time(deep) - time(shallow) cancels the launch, the store
   and any fixed cost. Results are cached per card name and power limit.

2. ``step_ceiling(cfm, M, N, batch_size)`` combines those rates with the
   counts of ``utils/flops.py``, per structure, on the card's engines:

       tensor cores  useful FLOPs x 3 TF32 passes / the TF32 rate
                     (the port's products are split TF32, csrc/scann_mma.cuh;
                     the neighbour gather is by index, not a product)
       CUDA cores    transcendentals / exp rate + elementwise / FMA rate
       HBM           bytes / the HBM rate

   With perfect overlap of the three, time = max(t); with none, sum(t).
   No real schedule beats the first, so it is an upper bound:

       structs_per_s = 1 / max(t)
       mfu_ceiling   = structs_per_s * useful FLOPs / peak_tflops

   ``schedule="keep_acts"`` counts the port's backward (each
   transcendental about once more from the stashed pre-activation);
   ``schedule="stash_all"`` the algorithmic minimum (1x forward
   transcendentals).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import time
from typing import Callable, Dict, Optional

import torch

from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.utils.flops import (
    TF32_PASSES,
    forward_flops_per_structure,
    hbm_bytes_per_structure,
    peak_tflops,
    train_flops_per_structure,
    vpu_costs_per_structure,
)

_CACHE_PATH = os.path.join(os.path.expanduser("~"), ".cache", "scann_tpu_torch",
                           "roofline.json")
MMA_FLOPS = 2 * 16 * 8 * 8   # one mma.sync m16n8k8
MMA_BF16_FLOPS = 2 * 16 * 8 * 16   # one mma.sync m16n8k16
STREAM_BYTES = 1 << 30       # the HBM probe's buffer: 1 GiB, far past the 50 MB L2


def _best_time(fn: Callable[[], None], sync: Callable[[], float], reps: int = 3) -> float:
    """Best of ``reps`` timings of ``fn`` (seconds from ``sync``) after a
    warm-up call."""
    fn()
    sync()
    return min(_timed(fn, sync) for _ in range(reps))


def _timed(fn, sync) -> float:
    t0 = sync()
    fn()
    return sync() - t0


def _nvidia_smi(fields: str) -> Optional[list]:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return [x.strip() for x in out.strip().splitlines()[0].split(",")]


def _float(x) -> Optional[float]:
    try:
        return float(x)
    except (TypeError, ValueError):
        return None


def _cuda_rates(scale: int, device: torch.device) -> Dict[str, float]:
    """The four probes of ``csrc/roofline_probe.cu`` on ``device``."""
    from scann_tpu_torch.kernels import _build

    lib = _build.load_library("roofline_probe")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.roofline_shape.argtypes = [vp]
    lib.roofline_shape.restype = None
    lib.roofline_fma.argtypes = [vp, ci, ci, ci, cf, cf, vp]
    lib.roofline_exp.argtypes = [vp, ci, ci, ci, vp]
    lib.roofline_mma.argtypes = [vp, ci, ci, ci, vp]
    lib.roofline_mma_bf16.argtypes = [vp, ci, ci, ci, vp]
    lib.roofline_stream.argtypes = [vp, ctypes.c_longlong, ci, ci, cf, cf, vp]
    for fn in (lib.roofline_fma, lib.roofline_exp, lib.roofline_mma, lib.roofline_mma_bf16,
               lib.roofline_stream):
        fn.restype = ci
    shape = (ctypes.c_int * 4)()
    lib.roofline_shape(shape)
    chains, unroll, mma_chains, mma_unroll = list(shape)

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks, threads = 4 * sms, 256        # 32 warps an SM, all resident
    out = torch.empty(blocks * threads, dtype=torch.float32, device=device)
    stream = lambda: torch.cuda.current_stream(device).cuda_stream

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"roofline probe {what}: launch failed (CUDA error {rc})")

    def sync() -> float:
        torch.cuda.synchronize(device)
        return time.perf_counter()

    def diff_rate(launch, lo, hi, ops_per_iter):
        """ops/s from the two-depth difference of ``launch(iters)``."""
        t_lo = _best_time(lambda: launch(lo), sync)
        t_hi = _best_time(lambda: launch(hi), sync)
        return ops_per_iter * (hi - lo) / max(t_hi - t_lo, 1e-9)

    it = lambda n: max(2, n // scale)
    elem_per_s = diff_rate(
        lambda n: check(lib.roofline_fma(out.data_ptr(), blocks, threads, n, 0.999, 1e-3,
                                         stream()), "fma"),
        it(8192), it(65536), blocks * threads * chains * unroll)
    exp_per_s = diff_rate(
        lambda n: check(lib.roofline_exp(out.data_ptr(), blocks, threads, n, stream()), "exp"),
        it(1024), it(8192), blocks * threads * chains * unroll)
    tf32 = diff_rate(
        lambda n: check(lib.roofline_mma(out.data_ptr(), blocks, threads, n, stream()), "mma"),
        it(4096), it(32768), blocks * threads // 32 * mma_chains * mma_unroll * MMA_FLOPS)
    bf16 = diff_rate(
        lambda n: check(lib.roofline_mma_bf16(out.data_ptr(), blocks, threads, n, stream()),
                        "mma_bf16"),
        it(4096), it(32768), blocks * threads // 32 * mma_chains * mma_unroll * MMA_BF16_FLOPS)

    buf = torch.zeros(STREAM_BYTES // 4, dtype=torch.float32, device=device)
    n4 = buf.numel() // 4

    def passes(n):
        for _ in range(n):
            check(lib.roofline_stream(buf.data_ptr(), n4, 8 * sms, 256, 0.999, 1e-3, stream()),
                  "stream")

    # nvidia-smi reads the clock while the card streams: the probe runs
    # first, then more passes until nvidia-smi has answered (at most 10 s)
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                            "--format=csv,noheader,nounits"], stdout=subprocess.PIPE,
                           stderr=subprocess.DEVNULL, text=True)
    try:
        hbm = diff_rate(passes, max(2, 8 // scale), max(4, 40 // scale), 2 * STREAM_BYTES)
        deadline = time.perf_counter() + 10.0
        while smi.poll() is None and time.perf_counter() < deadline:
            passes(4)
            sync()
        smi_out = smi.communicate(timeout=30)[0] if smi.poll() is not None else ""
    finally:
        if smi.poll() is None:
            smi.kill()
            smi.wait()
    del buf
    return {
        "exp_per_s": exp_per_s,
        "elem_per_s": elem_per_s,
        "fp32_tflops": 2 * elem_per_s / 1e12,
        "tf32_tflops": tf32 / 1e12,
        "bf16_tflops": bf16 / 1e12,
        "hbm_gbps": hbm / 1e9,
        "sm_clock_mhz": _float(smi_out.strip().split("\n")[0]) if smi_out.strip() else None,
    }


def _cpu_rates(scale: int) -> Dict[str, float]:
    """The same chains as small torch loops on the CPU: a check of the
    plumbing, not a ceiling of anything."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand(4096 * 512 // scale, generator=g) + 0.5
    K = max(2, 1024 // scale)
    sync = time.perf_counter

    def diff_rate(op, lo=16, hi=144):
        def chain(depth):
            def run():
                y = x.clone()
                for _ in range(K):
                    for _ in range(depth):
                        y = op(y)
            return run
        return x.numel() * K * (hi - lo) / max(_best_time(chain(hi), sync)
                                               - _best_time(chain(lo), sync), 1e-9)

    exp_per_s = diff_rate(lambda y: torch.exp(-y))
    elem_per_s = diff_rate(lambda y: torch.addcmul(torch.full_like(y, 1e-3), y,
                                                   torch.full_like(y, 0.999)))
    D = 128
    a = torch.randn(D, D, generator=g) / D ** 0.5
    KM = max(2, 1024 // scale)

    def mm(n):
        def run():
            y = a
            for _ in range(n):
                y = y @ a
        return run

    t_mm = _best_time(mm(KM), sync) - _best_time(mm(1), sync)
    a = a.bfloat16()
    t_bf16 = _best_time(mm(KM), sync) - _best_time(mm(1), sync)
    big = torch.zeros(STREAM_BYTES // 4 // (16 * scale))
    KS = max(2, 192 // scale)

    def stream(n):
        def run():
            for _ in range(n):
                big.mul_(0.999).add_(1e-3)
        return run

    t_hbm = _best_time(stream(KS), sync) - _best_time(stream(1), sync)
    return {
        "exp_per_s": exp_per_s,
        "elem_per_s": elem_per_s,
        "fp32_tflops": 2 * elem_per_s / 1e12,
        "tf32_tflops": (KM - 1) * 2 * D ** 3 / max(t_mm, 1e-9) / 1e12,
        "bf16_tflops": (KM - 1) * 2 * D ** 3 / max(t_bf16, 1e-9) / 1e12,
        "hbm_gbps": (KS - 1) * 2 * big.numel() * 4 / max(t_hbm, 1e-9) / 1e9,
        "sm_clock_mhz": None,
    }


def measure_device_rates(use_cache: bool = True, scale: int = 1,
                         device="cuda") -> Dict[str, float]:
    """Time this device's achievable rates.

    Returns ``device_kind`` (``torch.cuda.get_device_name``, or "cpu"),
    ``exp_per_s``, ``elem_per_s`` (FP32 FMAs/s), ``fp32_tflops`` (2 x that),
    ``tf32_tflops`` (dense TF32 ``mma.sync``, one m16n8k8 = 2048 FLOPs),
    ``bf16_tflops`` (dense BF16 ``mma.sync``, one m16n8k16 = 4096 FLOPs),
    ``hbm_gbps`` (bytes read + written per second), and the
    ``power_limit_w`` and ``sm_clock_mhz`` that ``nvidia-smi`` read beside
    the run (None on the CPU). Cached in ~/.cache/scann_tpu_torch/
    roofline.json under the card's name, power limit and ``scale``
    (``use_cache=False`` measures anew and rewrites the entry). ``scale``
    divides the chain depths; ``device="cpu"`` runs the chains as small
    torch loops (use ``scale=64``), which checks the plumbing and bounds
    nothing. A scaled run is kept under its own key, so a default call
    (and ``step_ceiling(rates=None)``) never reads it as the card's rates.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("measure_device_rates: no CUDA device (pass device='cpu' "
                               "for the plumbing check)")
        kind = torch.cuda.get_device_name(device)
        smi = _nvidia_smi("power.limit")
        power = _float(smi[0]) if smi else None
    else:
        kind, power = "cpu", None
    key = f"{kind}|{power}" + (f"|scale={scale}" if scale != 1 else "")
    if use_cache:
        try:
            with open(_CACHE_PATH) as f:
                cached = json.load(f).get(key)
        except (OSError, ValueError):
            cached = None
        if cached is not None:
            return cached
    rates = _cuda_rates(scale, device) if device.type == "cuda" else _cpu_rates(scale)
    rates = {"device_kind": kind, "power_limit_w": power, **rates}
    try:
        os.makedirs(os.path.dirname(_CACHE_PATH), exist_ok=True)
        try:
            with open(_CACHE_PATH) as f:
                cache = json.load(f)
        except (OSError, ValueError):
            cache = {}
        cache[key] = rates
        tmp = f"{_CACHE_PATH}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(cache, f)
        os.replace(tmp, _CACHE_PATH)
    except OSError:
        pass        # an unwritable cache costs a re-measure, nothing else
    return rates


def step_ceiling(cfm: ModelConfig, M: int, N: int, batch_size: int,
                 rates: Optional[Dict[str, float]] = None,
                 training: bool = True,
                 schedule: str = "keep_acts",
                 peak_tflops_override: Optional[float] = None) -> Dict[str, float]:
    """Per-structure time on each engine and the throughput/MFU ceiling.

    Returns the engine times (microseconds a structure), the binding engine
    ("tensor", "cuda_cores" or "hbm"), ``structs_per_s`` (perfect overlap)
    and ``structs_per_s_serial`` (none), ``mfu_ceiling`` and ``mfu_serial``
    against ``peak_tflops`` (None for a card not in its table) and the
    counts behind them. See the module docstring for the model."""
    if rates is None:
        rates = measure_device_rates()
    if schedule not in ("keep_acts", "stash_all"):
        raise ValueError(f"unknown schedule {schedule!r}")

    useful = (train_flops_per_structure(cfm, M, N) if training
              else forward_flops_per_structure(cfm, M, N))
    tensor_flops = TF32_PASSES * useful
    ops = vpu_costs_per_structure(cfm, M, N, training=training)
    trans, elem = ops["transcendentals"], ops["elementwise"]
    if schedule == "stash_all" and training:
        trans /= 2.0  # algorithmic minimum: 1x forward transcendentals

    t_tensor = tensor_flops / (rates["tf32_tflops"] * 1e12)
    t_cuda = trans / rates["exp_per_s"] + elem / rates["elem_per_s"]
    t_hbm = (hbm_bytes_per_structure(cfm, M, N, batch_size, training=training)
             / (rates["hbm_gbps"] * 1e9))
    t = max(t_tensor, t_cuda, t_hbm)
    engine = "tensor" if t == t_tensor else "cuda_cores" if t == t_cuda else "hbm"
    t_serial = t_tensor + t_cuda + t_hbm

    kind = rates.get("device_kind")
    peak = peak_tflops_override or (peak_tflops(kind) if kind else None)
    rate, rate_serial = 1.0 / t, 1.0 / t_serial
    return {
        "t_tensor_us": t_tensor * 1e6,
        "t_cuda_cores_us": t_cuda * 1e6,
        "t_hbm_us": t_hbm * 1e6,
        "binding_engine": engine,
        "structs_per_s": rate,
        "mfu_ceiling": (rate * useful / 1e12 / peak) if peak else None,
        "structs_per_s_serial": rate_serial,
        "mfu_serial": (rate_serial * useful / 1e12 / peak) if peak else None,
        "useful_flops_per_structure": useful,
        "tensor_flops_per_structure": tensor_flops,
        "transcendentals_per_structure": trans,
        "elementwise_per_structure": elem,
        "schedule": schedule,
    }
