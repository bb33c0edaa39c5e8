"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the serving path from ``scann_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card, then
serves a few QM9 molecules over HTTP through ``PredictionServer`` at the
full width of the flagship QM9 SCANN+ model (``configs/model_qm9.yaml``:
7 layers, D=128, 8 heads, embedding 48; random weights from a seed) and
checks every answer against the eager model on the card.

Prints the card (``nvidia-smi``), the build time, each comparison, the
serving results, then one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Exits non-zero on any failure, and
without printing a result when CUDA is not available.

Tolerance: rtol 1e-4, atol 1e-5 on pred and GA scores. The kernel sums its
FP32 products in another order than cuBLAS (TF32 off) and carries the
difference through 7 LayerNormed layers; agreement is typically ~1e-6.
"""

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

RTOL, ATOL = 1e-4, 1e-5
H100_FP32_FLOPS = 67e12      # H100 SXM, FP32 outside the tensor cores
H100_HBM_BYTES_S = 3.35e12   # H100 SXM HBM3


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def synthetic_batch(rng, B, M, N, use_ring=False, cgcnn=False, n_atoms=10,
                    min_atoms=3):
    """Random valid padded inputs: ragged atom and neighbour counts."""
    counts = rng.integers(min_atoms, M + 1, size=B)
    x = {"atomic": np.zeros((B, M), np.int32),
         "atom_mask": np.zeros((B, M, 1), np.float32),
         "neighbors": np.zeros((B, M, N), np.int32),
         "neighbor_mask": np.zeros((B, M, N), np.float32),
         "neighbor_weight": np.zeros((B, M, N), np.float32),
         "neighbor_distance": np.zeros((B, M, N), np.float32)}
    for b, na in enumerate(counts):
        x["atomic"][b, :na] = rng.integers(1, n_atoms, size=na)
        x["atom_mask"][b, :na, 0] = 1.0
        for m in range(na if na > 1 else 0):   # a lone atom has no neighbours
            k = rng.integers(1, min(N, na) + 1)
            x["neighbors"][b, m, :k] = rng.integers(0, na, size=k)
            x["neighbor_mask"][b, m, :k] = 1.0
            x["neighbor_weight"][b, m, :k] = rng.uniform(0.3, 3.0, size=k)
            x["neighbor_distance"][b, m, :k] = rng.uniform(0.8, 4.0, size=k)
    if use_ring:
        x["ring_aromatic"] = (rng.integers(0, 2, size=(B, M, 2))
                              * x["atom_mask"]).astype(np.float32)
    if cgcnn:
        x["atomic"] = ((rng.uniform(size=(B, M, 92)) < 0.05)
                       * x["atom_mask"]).astype(np.float32)
    return {k: torch.from_numpy(v).cuda() for k, v in x.items()}


def errors(got, want):
    diff = (got - want).abs()
    ok = bool((diff <= ATOL + RTOL * want.abs()).all()) and bool(torch.isfinite(got).all())
    rel = (diff / want.abs().clamp_min(1e-30)).max().item()
    return diff.max().item(), rel, ok


def cuda_ms(fn, reps=25):
    """Median of per-call CUDA-event times after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def benzene():
    ang = np.deg2rad(np.arange(6) * 60.0)
    c = np.stack([1.39 * np.cos(ang), 1.39 * np.sin(ang), np.zeros(6)], 1)
    h = np.stack([2.47 * np.cos(ang), 2.47 * np.sin(ang), np.zeros(6)], 1)
    return ["C"] * 6 + ["H"] * 6, np.concatenate([c, h]).tolist()


MOLECULES = {  # name -> (species, cartesian coordinates in Angstrom)
    "water": (["O", "H", "H"],
              [[0.0, 0.0, 0.1173], [0.0, 0.7572, -0.4692], [0.0, -0.7572, -0.4692]]),
    "methane": (["C", "H", "H", "H", "H"],
                [[0, 0, 0], [0.6291, 0.6291, 0.6291], [-0.6291, -0.6291, 0.6291],
                 [-0.6291, 0.6291, -0.6291], [0.6291, -0.6291, -0.6291]]),
    "ethanol": (["C", "C", "O", "H", "H", "H", "H", "H", "H"],
                [[1.1879, -0.3829, 0.0], [0.0, 0.5526, 0.0], [-1.1867, -0.2472, 0.0],
                 [-1.9237, 0.385, 0.0], [2.0985, 0.2306, 0.0], [1.1184, -1.0093, 0.8869],
                 [1.1184, -1.0093, -0.8869], [0.0227, 1.1812, 0.8852],
                 [0.0227, 1.1812, -0.8852]]),
    "benzene": benzene(),
}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.kernels import _build
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.models.scann import init_params, scann_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    t0 = time.time()
    _build.build_all(force=True)
    print(f"built {list(_build.SOURCES)} with nvcc in {time.time() - t0:.1f} s", flush=True)

    failures = []
    max_err = 0.0

    # ---- phase 1: kernel vs plain version on the card ---------------------
    def compare(name, cfm, inputs, mrelu=False, seed=0):
        nonlocal max_err
        params = init_params(cfm, torch.Generator().manual_seed(seed), "cuda")
        with torch.inference_mode():
            pred, ga = kfwd.fused_scann_forward(params, inputs, cfm, mrelu)
            torch.cuda.synchronize()
            pred0, ga0 = kfwd.reference_scann_forward(params, inputs, cfm, mrelu)
        line = [name, f"B={inputs['atomic'].shape[0]} M={inputs['atomic'].shape[1]} "
                      f"N={inputs['neighbors'].shape[2]}"]
        for what, got, want in (("pred", pred, pred0), ("ga", ga, ga0)):
            ab, rel, ok = errors(got, want)
            max_err = max(max_err, ab)
            line.append(f"{what} max_abs {ab:.3e} max_rel {rel:.3e}")
            if not ok:
                failures.append(f"{name} {what}: max_abs {ab:.3e} outside rtol {RTOL} atol {ATOL}")
        print("  ".join(line) + f"  (rtol {RTOL}, atol {ATOL})", flush=True)

    rng = np.random.default_rng(0)
    small = dict(n_atoms=10, embedding_dim=16, n_attention=2, local_dim=32, num_head=4,
                 global_dim=32, dense_out=16)
    matrix = [
        ("scann+", ModelConfig(**small, g_update=True), False),
        ("scann", ModelConfig(**small, g_update=False), False),
        ("scann ring mrelu", ModelConfig(**small, g_update=False, use_ring=True), True),
        ("scann+ ring", ModelConfig(**small, g_update=True, use_ring=True), False),
        ("scann+ cgcnn", ModelConfig(**small, g_update=True, feature="cgcnn"), False),
        ("scann+ ga_norm off", ModelConfig(**small, g_update=True, use_ga_norm=False), False),
    ]
    for name, cfm, mrelu in matrix:
        compare(name, cfm, synthetic_batch(rng, 8, 16, 8, cfm.use_ring,
                                           cfm.feature == "cgcnn"), mrelu)
    qm9_model = ModelConfig(n_atoms=10, embedding_dim=48, n_attention=7, local_dim=128,
                            num_head=8, global_dim=128, dense_out=128, scale=0.5,
                            use_attn_norm=True, use_ga_norm=True, use_ring=False,
                            g_update=True, gaussian_d=4.0)
    qm9_inputs = synthetic_batch(rng, 128, 32, 16)
    compare("qm9 full width", qm9_model, qm9_inputs)
    compare("qm9 single atoms", qm9_model, synthetic_batch(rng, 16, 8, 8, min_atoms=1))
    lone = synthetic_batch(rng, 4, 8, 8)
    lone["atom_mask"][0] = 0.0
    lone["atom_mask"][0, 0] = 1.0
    lone["neighbor_mask"][0] = 0.0
    compare("qm9 one-atom molecule", qm9_model, lone)
    compare("qm9 widest rung M=64", qm9_model, synthetic_batch(rng, 32, 64, 16))

    # ---- phase 2: the serving path, through HTTP --------------------------
    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.data.structure import Structure
    from scann_tpu_torch.serve import BatchedPredictor, PredictionServer

    cfg = ScannConfig(model=qm9_model,
                      hyper=HyperConfig(batch_size=128, target="homo",
                                        target_mean=-0.24, target_std=0.022),
                      tpu=TpuConfig(max_buckets=2))
    scann = Scann(cfg, device="cuda")
    scann.init_params(seed=0)
    batches = [0]
    forward_eval = scann.forward_eval

    def counted_forward_eval(params, batch):
        batches[0] += 1
        return forward_eval(params, batch)

    scann.forward_eval = counted_forward_eval
    mols = MOLECULES
    kfwd.fused_scann_forward.launches = 0          # counts of the main path only
    t_serve = time.time()
    predictor = BatchedPredictor(scann, max_batch=64, window_ms=20.0,
                                 warmup_shapes=[(12, 16)])
    server = PredictionServer(predictor, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://{server.host}:{server.port}"
    answers, latencies, sent = {}, {}, {}

    def post(name, body, ctype):
        t = time.time()
        req = urllib.request.Request(base + "/predict", data=body,
                                     headers={"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                answers[name] = (r.status, json.loads(r.read()))
        except Exception as e:  # recorded, then reported as a failure below
            answers[name] = (getattr(e, "code", None), {"error": repr(e)})
        latencies[name] = 1e3 * (time.time() - t)

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = (r.status, json.loads(r.read()))
        calls = []
        for name in ("water", "methane", "ethanol"):
            sp, xyz = mols[name]
            body = json.dumps({"structures": [{"species": sp, "coords": xyz,
                                               "lattice": None}]}).encode()
            calls.append((name, body, "application/json"))
        sp, xyz = mols["benzene"]
        sent["benzene"] = f"{len(sp)}\nbenzene\n" + "".join(
            f"{s} {x:.4f} {y:.4f} {z:.4f}\n" for s, (x, y, z) in zip(sp, xyz))
        calls.append(("benzene", sent["benzene"].encode(), "text/plain"))
        threads = [threading.Thread(target=post, args=c) for c in calls]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    finally:
        server.shutdown()
        thread.join(10)
    torch.cuda.synchronize()
    serve_s = time.time() - t_serve
    launches = kfwd.fused_scann_forward.launches
    device_batches = batches[0]

    print(f"healthz {health}", flush=True)
    if health[0] != 200 or health[1].get("status") != "ok":
        failures.append(f"healthz answered {health}")
    for name, (sp, xyz) in mols.items():
        status, out = answers.get(name, (None, {}))
        if status != 200:
            failures.append(f"{name}: HTTP {status} {out}")
            continue
        value, ga = out["predictions"][0], np.asarray(out["ga_scores"][0])
        # the reference featurizes exactly what was sent (the xyz text is rounded)
        struct = (Structure.from_xyz_lines(sent[name].splitlines()) if name in sent
                  else Structure(sp, xyz))
        _, inputs = scann.featurize_structures([struct])
        with torch.inference_mode():
            p0, g0 = scann_forward(scann.params, scann._to_device(inputs[0]), qm9_model)
        ref = p0[0, 0].item() * cfg.hyper.target_std + cfg.hyper.target_mean
        ref_ga = g0[0, :len(sp), 0].cpu().numpy()
        err_v = abs(value - ref)
        err_g = float(np.abs(ga - ref_ga).max())
        ok = (np.isfinite(value) and np.isfinite(ga).all() and ga.shape == (len(sp),)
              and err_v <= ATOL + RTOL * abs(ref)
              and np.all(np.abs(ga - ref_ga) <= ATOL + RTOL * np.abs(ref_ga)))
        print(f"{name}: HTTP 200 {cfg.hyper.target}={value:.6f} eager={ref:.6f} "
              f"|d|={err_v:.2e} ga max|d|={err_g:.2e} latency {latencies[name]:.1f} ms",
              flush=True)
        if not ok:
            failures.append(f"{name}: served answer differs from the eager model "
                            f"({err_v:.3e}, {err_g:.3e})")
    print(f"serving: {len(answers)} requests, {device_batches} device batches, "
          f"{launches} kernel launches, {serve_s:.1f} s from predictor start", flush=True)
    if launches == 0 or launches != device_batches:
        failures.append(f"kernel launches {launches} != device batches {device_batches}")

    # ---- phase 3: time the kernel at the QM9 serving shape -----------------
    params = init_params(qm9_model, torch.Generator().manual_seed(0), "cuda")
    packed = kfwd.pack_params(params, qm9_model)
    with torch.inference_mode():
        kfwd._check_inputs(qm9_inputs, qm9_model, packed["wde"].device)
        kernel_ms = cuda_ms(lambda: kfwd._launch(packed, qm9_inputs, qm9_model, False))
        plain_ms = cuda_ms(lambda: kfwd.reference_scann_forward(params, qm9_inputs,
                                                                 qm9_model))
    B, M = qm9_inputs["atomic"].shape
    N = qm9_inputs["neighbors"].shape[2]
    flops = kfwd.forward_flops(qm9_model, B, M, N)
    nbytes = (sum(t.numel() * t.element_size() for t in qm9_inputs.values())
              + sum(t.numel() * t.element_size() for t in packed.values())
              + 4 * (B + B * M))
    ops_ms = 1e3 * flops / H100_FP32_FLOPS
    bytes_ms = 1e3 * nbytes / H100_HBM_BYTES_S
    print(f"scann_forward at B={B} M={M} N={N}: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, {flops:.4e} FLOP, {nbytes} bytes, bound "
          f"{max(ops_ms, bytes_ms):.4f} ms ({100 * max(ops_ms, bytes_ms) / kernel_ms:.1f}% "
          f"of it reached)", flush=True)

    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), flush=True)
        return 1
    kernels = [{
        "name": "scann_forward", "route": "cuda", "source": kfwd.SOURCE,
        "replaces": kfwd.REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None, "flops": flops,
    }]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
