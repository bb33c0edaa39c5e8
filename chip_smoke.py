"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port and the rate probes from
``scann_tpu_torch/csrc`` (one nvcc per source, all at once) and prints the
registers and spills of the two backward kernels. Phases 11 and 12 run
first:

11. measures the card's rates with the probes of ``csrc/roofline_probe.cu``
   (``utils.roofline.measure_device_rates``: ``expf``, FP32 FMA, TF32
   ``mma.sync``, HBM stream over 1 GiB) and prints each beside its
   published peak (``utils.flops``), the SM clock and the power limit; a
   rate over 105% of its peak fails (a wrong probe). Every later bound is
   also taken at these rates (``measured_bound_ms``, beside the published
   ``bound_ms``, which stays the bound); prints the step ceilings
   (``step_ceiling``) of the QM9 and MP2018 shapes;
12. featurizes the same structures by the native Voronoi path
   (``native/voronoi_cell.cc``, the default) and the scipy/Qhull path:
   MP2018-like crystals of phase 10's set, phase 8's served crystals (20-200
   sites) and QM9-like molecules of phase 5's set; prints ms per structure
   on each path and fails if the neighbour records differ.

Phases 1-5 run at the full width of the
flagship QM9 SCANN+ model (``configs/model_qm9.yaml``: 7 layers, D=128, 8
heads, embedding 48), phases 6-10 at the full width of the crystal models
(``configs/model_mp2018.yaml``: SCANN+, 9 layers, D=128, embedding 128,
vocab 95; ``configs/model_ptgp.yaml``: SCANN with ring features, 11
layers); random weights from seeds:

1. holds the forward kernel against its plain PyTorch version, unpacked
   and on packed slots (structure packing: several structures a slot, up to
   8 segments, at least one empty; the small matrix in slots of 16 rows and
   QM9 molecules of 3-29 atoms at the flagship's packing capacity 48 and at
   the derived 32);
2. serves a few molecules over HTTP through ``PredictionServer`` (the
   serving path) and checks every answer against the eager model; spans
   (``utils.Timer``, each ended by ``torch.cuda.synchronize()``) split each
   request's wall time into queue wait, featurize, hand-off, pad/launch and
   response (``ServingSpans``);
3. times both kernels at the QM9 batch shape against their bounds and
   their plain versions, and the packed forward at capacity 48 and the
   packed backward at capacity 32;
4. holds the products of ``csrc/scann_mma.cuh`` (split-TF32 ``mma.sync``, the
   three forms the backward kernels use) against a float64 product, then the
   backward kernel (at dropout 0 and 0.1, one-shot and with a
   GA cotangent) and the forward kernel with dropout against their plain
   versions on the same Philox masks, unpacked and packed;
5. trains 2 epochs through ``Scann.prepare_dataset -> train -> evaluate``
   (the training path) on ~1000 synthetic QM9-like molecules in the
   flagship recipe's two buckets; checks the launches, that each pass over
   a bucket lowers that bucket's loss without dropout, that the same run
   with the plain step gives the same losses, 3 kernel steps against 3
   plain steps and ``load_model_infer``; then trains 2 epochs in one
   bucket and checks that the epoch loss and the training-set loss fall;
   then, with ``tpu.structure_packing`` on the same molecules, 3 epochs at
   packing capacity 48 (eval by the molecule forward, steps by the loop
   backward) and 1 at the derived capacity 32 (steps by the molecule
   backward): the routes, one launch per step and per eval batch, a falling
   loss, ``predict_data`` per structure (values and GA scores) against the
   unpacked pipeline with the same parameters, and occupancy, slots, slot
   batch, median step and structures/s beside the unpacked run's;
6. holds the crystal loop-forward kernel against its plain version at 1, 2
   and 4 blocks per structure: a small matrix of configurations (two atom
   blocks, ragged counts, single atoms, fewer atoms than blocks, dropout 0
   and 0.1 with attention dropout), a ragged M=160 at B=20, the gate's edge
   M=232, MP2018 (B=64 and B=128, M=96, N=32) and Pt/graphene (B=64, M=128,
   N=32) at full width, and packed slots (the small matrix, MP2018-like
   crystals of 20-90 sites at packing capacity 96), each with further
   launches on a kept scratch filled with NaN or a constant that must give
   the same pred and ga bit for bit; and times it in turns with its plain
   version at MP2018 on 2 blocks and on 1 block per structure, at B=128, at
   Pt/graphene and packed at capacity 96;
7. holds the per-layer LocalAttention kernel against its plain version
   (out, geometry, attention; SCANN+ and SCANN) at a ragged small layer, at
   an M beyond the loop kernel's gate (8, 256, 32) and at one MP2018 layer
   (64, 96, 32), each relaunched into outputs filled with NaN that must
   come back bit for bit; times it in turns with its plain version at the
   last two shapes (and back to back, without the host's share of a call);
   holds the per-layer model against the eager model for
   ``use_attn_norm: false``;
8. (run last) serves synthetic periodic crystals of 20-90 sites, posted as
   CIF and as JSON, and one of 200 sites that takes the per-layer route,
   through ``PredictionServer`` on the MP2018 model that phase 10 trained,
   loaded from its run directory (``BatchedPredictor.from_model_dir``; the
   crystal serving path); prints each request's batch size (a group
   launches at its own size), checks every answer against the eager model
   and the launches of each route against the batches that took it, and
   splits each request's wall time by spans as phase 2 does;
9. holds the crystal loop-backward kernel against its plain version (the
   eager training forward under ``torch.autograd``, same Philox masks): a
   small matrix in cotangent and one-shot mode at dropout 0 and 0.1, atom
   blocks of 32, 16 and 8, structures with fewer atoms than blocks and with
   unequal shares, then MP2018 (B=64, M=96, at N=32 and at N=16) and
   Pt/graphene (B=64, M=128, N=32) at full width, and packed slots (the
   small matrix, QM9 at capacity 48, MP2018-like crystals at 96) at every
   cluster size the kernel launches with (1, 2 and, for small batches, 4
   blocks per structure), each with further launches on a kept scratch
   filled with NaN or a constant that must give the same gradients bit for
   bit, and times it in turns with its plain version (plain, kernel, kernel,
   plain), at one block per structure beside the cluster, at B=128 beside
   B=64, and packed at QM9 capacity 48 and crystal capacity 96;
10. trains 2 epochs through ``Scann.prepare_dataset -> train -> evaluate``
   (the crystal training path) on 480 synthetic periodic crystals of 20-90
   sites at the full width and depth of the MP2018 model, batch 64, in the
   recipe's 4 buckets with the neighbour axis padded to the recipe's 32 (the
   largest is the recipe's (96, 32)); holds the kernel against its plain
   version on the first batch of every bucket; checks one loop-backward
   launch per step and none of the molecule backward, the eval launches
   against the routes, the same run with the plain step and
   ``load_model_infer``; trains 2 epochs in one bucket (96, 16), where every
   pass must lower the loss without dropout; and takes one training step by
   the per-layer route on structures beyond the loop backward's gate, held
   against the plain step; then one packed epoch of the same crystals at
   capacity 96 (eval by the loop forward, steps by the loop backward),
   checked as phase 5's packed runs; and two training steps at (96, 32)
   under ``utils.trace`` (``torch.profiler``, as ``cli/train.py --profile``
   runs it): the Chrome trace must be written, and its CUDA kernel events
   are counted and summed by name.

Phases 5, 8 and 10 featurize through the native Voronoi path and pack
through the native packer (``native/packer.cc``), both built with g++ at
first use.

Prints the card (``nvidia-smi``), the build time, each comparison and
phase, each kernel's share of both bounds, then one ``{"kernels": [...]}``
line (every row with ``measured_bound_ms``; the rows of the four
whole-model kernels with ``packed_launches``, their launches on the packed
training runs, and ``packed``, their times at a packed shape) and, last,
``{"ok": true, "device": {...}}``. Exits non-zero on any failure, and
without printing a result when CUDA is not available.

Tolerances. Forward (molecule and crystal kernels, per-layer kernel's out
and geometry): rtol 1e-4, atol 1e-5: the kernels sum their products (three
TF32 passes on the tensor cores, accumulated in f32) in another order than
cuBLAS (TF32 off) and carry the difference through 7 to 11 LayerNormed
layers; the per-layer kernel's attention probabilities: rtol 1e-4, atol
1e-6. Backward: pred as the forward; each gradient within 1e-4 x its max
|plain|, since FP32 sums over up to 196,608 rows run in another order; the
kernels' tensor-core products within 2e-6 x max |exact| of a float64
product, where a single TF32 pass reads about 3e-4. Training:
3-step and single-step losses to 1e-4 relative; the two-epoch runs' losses
to 1e-3 relative, since Adam carries the FP32 differences through 16 steps.
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
ATTN_ATOL = 1e-6             # attention probabilities of the per-layer kernel
GRAD_RTOL = 1e-4             # of each gradient's max |plain|
MMA_RTOL = 2e-6              # split-TF32 products, of max |float64 product|
LOSS_RTOL = 1e-4
TRAIN_RTOL = 1e-3            # two epochs, kernel against plain step
RATE_LIMIT = 1.05            # a measured rate over 105% of its published peak: a bad probe

# The H100 SXM's published rates (utils/flops.py's table), which the bounds
# use; ``MEASURED`` holds the rates the roofline phase measures on this card,
# which ``bound_ms`` also applies to the same work (``measured_bound_ms``).
H100 = "NVIDIA H100 80GB HBM3"
MEASURED = {}


def published_rates():
    """(FP32 FLOP/s, TF32 FLOP/s, HBM bytes/s, expf/s) of the H100 SXM."""
    from scann_tpu_torch.utils import flops

    return (flops.peak_fp32_tflops(H100) * 1e12, flops.peak_tflops(H100) * 1e12,
            flops.peak_hbm_bytes_s(H100), flops.peak_exp_per_s(H100))


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


def pack_batch(x, capacity, segments=8):
    """A padded batch on the card bin-packed into slots of ``capacity`` rows
    (``data/packing.pack_padded_inputs``, structure packing), its one-hot
    widened to ``segments`` columns: every slot with fewer structures has
    empty segments, and the batch has at least one."""
    from scann_tpu_torch.data.packing import pack_padded_inputs

    p = pack_padded_inputs({k: v.cpu().numpy() for k, v in x.items()}, capacity=capacity,
                           max_segments=segments)
    out = dict(p.inputs)
    slots, used = p.indices.shape
    out["segment_onehot"] = np.concatenate(
        [out["segment_onehot"], np.zeros((slots, capacity, segments - used), np.float32)], -1)
    out["segment_mask"] = np.concatenate(
        [out["segment_mask"], np.zeros((slots, segments - used), np.float32)], -1)
    if out["segment_mask"].all():
        raise AssertionError("a packed batch without an empty segment")
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in out.items()}


def packed_label(x):
    """' packed S=..' for a packed batch, '' otherwise."""
    seg = x.get("segment_onehot")
    if seg is None:
        return ""
    empty = int((x["segment_mask"] == 0).sum())
    return f" packed S={seg.shape[-1]} ({empty} empty segments)"


def errors(got, want):
    diff = (got - want).abs()
    ok = bool((diff <= ATOL + RTOL * want.abs()).all()) and bool(torch.isfinite(got).all())
    rel = (diff / want.abs().clamp_min(1e-30)).max().item()
    return diff.max().item(), rel, ok


def cuda_times(fn, reps=25, warmup=3):
    """Per-call CUDA-event times after a warm-up."""
    for _ in range(warmup):
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
    return times


def cuda_ms(fn, reps=25):
    """Median of per-call CUDA-event times after a warm-up."""
    return statistics.median(cuda_times(fn, reps))


def in_turns_ms(plain, kernel, plain_reps=5, kernel_reps=10):
    """(kernel ms, plain ms): medians over two rounds each, taken in the
    order plain, kernel, kernel, plain, so that a drift of the card's clock
    falls on both alike."""
    p = cuda_times(plain, plain_reps, warmup=2)
    k = cuda_times(kernel, kernel_reps) + cuda_times(kernel, kernel_reps, warmup=0)
    p += cuda_times(plain, plain_reps, warmup=0)
    return statistics.median(k), statistics.median(p)


def back_to_back_ms(fn, reps=20):
    """ms per call of ``reps`` calls between two CUDA events after a warm-up:
    the device's time, the host's work of each call hidden behind the calls
    before it (``cuda_times`` waits for each call, so it counts that work
    where the device is faster than the host)."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


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


def grad_errors(got, want):
    """(worst |got - want| / max |want| over the gradient tensors, its key,
    the largest absolute difference)."""
    worst, where, ab = 0.0, None, 0.0
    for k, w in want.items():
        d = (got[k] - w).abs().max().item()
        rel = d / max(w.abs().max().item(), 1e-30)
        ab = max(ab, d)
        if rel > worst or where is None:
            worst, where = rel, k
    return worst, where, ab


def hold_backward(label, what, got_p, want_p, got_g, want_g, line, failures):
    """Hold one backward launch against its plain version: pred (when
    given) at RTOL / ATOL, each gradient within GRAD_RTOL x its max |plain|.
    Appends to the printed ``line`` and to ``failures``; returns the largest
    absolute difference."""
    worst = 0.0
    if got_p is not None:
        worst, _, ok = errors(got_p, want_p)
        line.append(f"{what} pred {worst:.2e}")
        if not ok:
            failures.append(f"{label} {what} pred: max_abs {worst:.3e}")
    if set(got_g) != set(want_g):
        failures.append(f"{label} {what}: gradient keys differ")
        return worst
    rel, key, ab = grad_errors(got_g, want_g)
    finite = all(bool(torch.isfinite(v).all()) for v in got_g.values())
    line.append(f"{what} grads worst {rel:.2e} of max|plain| at {key}")
    if rel > GRAD_RTOL or not finite:
        failures.append(f"{label} {what}: gradient {key} off by {rel:.3e} of its max "
                        f"(limit {GRAD_RTOL}), finite={finite}")
    return max(worst, ab)


def hold_loop_backward(label, cfm, p, x, y, mrelu, rate, seed, failures, ct=None, relaunches=0,
                       clusters=None):
    """Hold the crystal loop-backward kernel against its plain version on one
    batch, at every cluster size of ``clusters`` (blocks per structure; the
    wrapper's own choice for this batch size when None): in one-shot mode,
    and in cotangent mode when ``ct`` = (d pred, d ga) is given. With
    ``relaunches``, that many further one-shot launches run at each cluster
    size on a kept scratch (as a Trainer keeps its scratch from step to step)
    that is filled with NaN before one launch and with a finite constant
    before the next: each must return the first launch's pred and gradients
    bit for bit, so a race, or a read of scratch that the launch itself did
    not write, fails here. Prints one line per cluster size; returns the
    largest absolute difference from the plain version."""
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop

    B, M = x["atom_mask"].shape[:2]
    N = x["neighbors"].shape[2]
    S = kfwd.segment_count(x)
    chunk_atoms, block, _ = kloop.loop_backward_memory_plan(cfm, M, N, S)
    own = kloop.cluster_size(B)
    packed = kfwd.pack_params(p, cfm)
    pred0, g0 = kloop.reference_loop_train_grads(p, x, y, cfm, mrelu, rate, seed)
    g2 = kloop.reference_loop_grad(p, x, cfm, ct[0], ct[1], rate, seed) if ct is not None else None
    worst = 0.0
    for C in clusters or (own,):
        tag = (f"{label} B={B} M={M} N={N}{packed_label(x)} (atom block {block}, "
               f"{chunk_atoms} per chunk, {C} blocks per structure) dropout {rate}")
        line = [tag]
        if C == own:    # through the public entry points, which choose C themselves
            pred, g = kloop.loop_scann_train_grads(p, x, y, cfm, mrelu, rate, seed)
        else:
            flat, pred = kloop.launch_loop_backward(packed, x, cfm, y, None, True, mrelu, rate,
                                                    seed, 0, None, C)
            pred, g = pred.view(B, -1), kbwd.grads_from_flat(flat, packed, cfm)
        torch.cuda.synchronize()
        worst = max(worst, hold_backward(tag, "one-shot", pred, pred0, g, g0, line, failures))
        if ct is not None:
            if C == own:
                g1 = kloop.loop_scann_grad(p, x, cfm, ct[0], ct[1], rate, seed)
            else:
                flat, _ = kloop.launch_loop_backward(packed, x, cfm, ct[0], ct[1], False, False,
                                                     rate, seed, 0, None, C)
                g1 = kbwd.grads_from_flat(flat, packed, cfm)
            torch.cuda.synchronize()
            worst = max(worst, hold_backward(tag, "ct_ga", None, None, g1, g2, line, failures))
        if relaunches:
            scratch = kloop.loop_backward_scratch(packed, cfm, B, M, N, C)
            differ = set()
            for i in range(relaunches):
                for t in scratch.values():
                    if t is not None:
                        t.fill_(float("nan") if i % 2 == 0 else -3.0)
                flat, pred_i = kloop.launch_loop_backward(packed, x, cfm, y, None, True, mrelu,
                                                          rate, seed, 0, scratch, C)
                again = kbwd.grads_from_flat(flat, packed, cfm)
                differ |= {k for k in g if not torch.equal(g[k], again[k])}
                if not torch.equal(pred_i.view(B, -1), pred):
                    differ.add("pred")
            line.append(f"{relaunches} launches on NaN- and constant-filled scratch "
                        f"bit-identical: {not differ}")
            if differ:
                failures.append(f"{tag}: launches on the same inputs differ in {sorted(differ)}")
            del scratch
        print("  ".join(line), flush=True)
    return worst


def check_products(failures, card):
    """The three products of csrc/scann_mma.cuh on one block, on seeded
    inputs, against a float64 product (torch.matmul is the yardstick here
    only): a single TF32 pass would be about 3e-4 off, so a result within
    MMA_RTOL shows that all three passes are there."""
    from scann_tpu_torch.kernels import scann_backward as kbwd

    g = torch.Generator().manual_seed(4)
    worst = 0.0
    for rows, K, nc in ((32, 256, 128), (32, 128, 128), (24, 20, 128), (8, 60, 60), (64, 128, 32)):
        a = torch.randn(rows, K, generator=g).cuda()
        w = torch.randn(K, nc, generator=g).cuda()
        y = torch.randn(rows, nc, generator=g).cuda()
        got = kbwd.mma_selftest(a, w, y)
        torch.cuda.synchronize()
        exact = a.double() @ w.double()
        want = (exact, exact, a.double().t() @ y.double(), y.double().sum(0))
        rel = [float((o.double() - e).abs().max() / e.abs().max()) for o, e in zip(got, want)]
        one = float((kbwd.reference_tf32x3_matmul(a, w, passes=1).double() - exact).abs().max()
                    / exact.abs().max())
        worst = max(worst, *rel)
        print(f"products [{rows}, {K}] @ [{K}, {nc}]: x @ W {rel[0]:.2e}, the same from W's "
              f"transpose {rel[1]:.2e}, x^T dy {rel[2]:.2e}, column sums {rel[3]:.2e} of max "
              f"|float64 product| (limit "
              f"{MMA_RTOL}; one TF32 pass alone: {one:.2e})", flush=True)
        if not all(r <= MMA_RTOL for r in rel):
            failures.append(f"split-TF32 products at [{rows}, {K}] @ [{K}, {nc}]: {rel}")
    print(f"products: worst {worst:.3e} of max |exact|  [{card}]", flush=True)


def time_backward(cfm, params, packed, inputs, card):
    """Phase 3 for the backward kernel: its launch plus the row reduction at
    the QM9 training shape (dropout 0.1, one-shot), against its bound and
    its plain version (the eager training forward under torch.autograd)."""
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd

    B, M = inputs["atomic"].shape
    N = inputs["neighbors"].shape[2]
    S = max(kfwd.segment_count(inputs), 1)
    y = torch.from_numpy(np.random.default_rng(1).normal(size=(B, S)).astype(np.float32)).cuda()
    kfwd._check_inputs(inputs, cfm, packed["wde"].device)
    ms, plain_ms = in_turns_ms(
        lambda: kbwd.reference_fused_scann_train_grads(params, inputs, y, cfm, False, 0.1, 7),
        lambda: kbwd._launch(packed, inputs, cfm, y, None, True, False, 0.1, 7), 5, 12)
    flops = kbwd.backward_flops(cfm, B, M, N)
    recompute = kbwd.recompute_flops(cfm, B, M, N)
    _, P = kbwd.grad_layout(packed)
    nbytes = (sum(t.numel() * t.element_size() for t in inputs.values())
              + sum(t.numel() * t.element_size() for t in packed.values())
              + 4 * B * S + 4 * (P + B * S))  # targets in; gradients and pred out
    bound, by, measured = bound_ms(flops, nbytes, kbwd.backward_fp32_flops(cfm, B, M, N))
    print(f"scann_backward at B={B} M={M} N={N}{packed_label(inputs)} (dropout 0.1, one-shot, "
          f"with its row "
          f"reduction; timed in turns: plain, kernel, kernel, plain): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, {flops:.4e} FLOP, "
          f"{nbytes} bytes, bound {bound:.4f} ms ({100 * bound / ms:.1f}% of it reached)  "
          f"[{card}]", flush=True)
    print(f"scann_backward: the kernel's schedule adds {recompute:.4e} FLOP of recompute "
          f"({operations_ms(recompute, 0):.4f} ms as split-TF32 products), which the bound "
          f"does not count", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "flops": flops,
            "recompute_flops": recompute, "bound_by": by, "measured_bound_ms": measured}


def phase4(matrix, qm9_model, qm9_inputs, packed_qm9, failures, card):
    """The backward kernel (one-shot and with a GA cotangent) and the
    forward kernel with dropout against their plain versions, on the same
    Philox masks, unpacked and packed (the small matrix in slots of 16 rows,
    QM9 at the derived packing capacity 32). Returns the largest absolute
    errors."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(4)
    prng = np.random.default_rng(40)       # the packed batches' draws
    err = {"backward": 0.0, "forward_dropout": 0.0}
    cases = [(name, cfm, mrelu, 8, 16, 8, 3) for name, cfm, mrelu in matrix]
    cases += [("scann+ use_drop", dataclasses.replace(matrix[0][1], use_drop=True),
               False, 8, 16, 8, 3),
              ("qm9 width N=24 (one atom per chunk)", qm9_model, False, 8, 32, 24, 3),
              ("qm9 width single atoms", qm9_model, False, 8, 8, 8, 1)]
    for name, cfm, mrelu, B, M, N, min_atoms in cases:
        x = synthetic_batch(rng, B, M, N, cfm.use_ring, cfm.feature == "cgcnn",
                            min_atoms=min_atoms)
        p = init_params(cfm, torch.Generator().manual_seed(2), "cuda")
        for x, r in ((x, rng), (pack_batch(x, 2 * M), prng)) if (M, N) == (16, 8) else ((x, rng),):
            B, M = x["atom_mask"].shape[:2]
            S = max(kfwd.segment_count(x), 1)
            y = torch.from_numpy(r.normal(size=(B, S)).astype(np.float32)).cuda()
            ctp = torch.from_numpy(r.normal(size=(B, S)).astype(np.float32)).cuda()
            ctg = torch.from_numpy(r.normal(size=(B, M, 1)).astype(np.float32)).cuda()
            for rate in (0.0, 0.1):
                check_backward(f"{name}{packed_label(x)} dropout {rate}", cfm, p, x, y, ctp, ctg,
                               mrelu, rate, err, failures)
    for label, x in (("qm9 full width", qm9_inputs),
                     ("qm9 full width capacity 32", packed_qm9[32])):
        p = init_params(qm9_model, torch.Generator().manual_seed(3), "cuda")
        B = x["atomic"].shape[0]
        r = prng if kfwd.segment_count(x) else rng
        y = torch.from_numpy(r.normal(size=(B, max(kfwd.segment_count(x), 1)))
                             .astype(np.float32)).cuda()
        check_backward(f"{label}{packed_label(x)} dropout 0.1", qm9_model, p, x, y, None, None,
                       False, 0.1, err, failures)
    print(f"phase 4: worst backward abs error {err['backward']:.3e}, forward with dropout "
          f"{err['forward_dropout']:.3e}  [{card}]", flush=True)
    return err


def check_backward(label, cfm, p, x, y, ctp, ctg, mrelu, rate, err, failures):
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd

    seed = 11
    with torch.no_grad():
        pf, gf = kfwd.fused_scann_forward(p, x, cfm, mrelu, rate, seed)
        torch.cuda.synchronize()
        pr, gr = kfwd.reference_scann_forward(p, x, cfm, mrelu, rate, seed)
    line = [label]
    for what, got, want in (("fwd pred", pf, pr), ("fwd ga", gf, gr)):
        ab, _, ok = errors(got, want)
        err["forward_dropout"] = max(err["forward_dropout"], ab)
        line.append(f"{what} {ab:.2e}")
        if not ok:
            failures.append(f"{label} {what}: max_abs {ab:.3e} outside rtol {RTOL} atol {ATOL}")
    pred, g = kbwd.fused_scann_train_grads(p, x, y, cfm, mrelu, rate, seed)
    torch.cuda.synchronize()
    pred0, g0 = kbwd.reference_fused_scann_train_grads(p, x, y, cfm, mrelu, rate, seed)
    checks = [("one-shot", pred, pred0, g, g0)]
    if ctp is not None:
        g1 = kbwd.fused_scann_grad(p, x, cfm, ctp, ctg, rate, seed)
        torch.cuda.synchronize()
        checks.append(("ct_ga", None, None, g1,
                       kbwd.reference_fused_scann_grad(p, x, cfm, ctp, ctg, rate, seed)))
    for what, got_p, want_p, got_g, want_g in checks:
        err["backward"] = max(err["backward"], hold_backward(label, what, got_p, want_p, got_g,
                                                             want_g, line, failures))
    print("  ".join(line), flush=True)


def bucket_losses(trainer, buckets):
    """RMSE + l2 of the trainer's current weights on each bucket, without
    dropout (the forward kernels). The launch counters and the trainer's
    counting wrapper are left as they were."""
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import l2_penalty

    counters = (kfwd.fused_scann_forward, kloop.launch_loop_forward, kla.fused_local_attention)
    saved = [c.launches for c in counters]
    wrapper = trainer.__dict__.pop("forward_eval", None)
    l2 = float(l2_penalty(trainer.params, trainer.config.hyper.l2_reg))
    out = []
    for b, dev in zip(buckets, trainer._put_buckets(buckets, "train")):
        _, _, pred, y = trainer._evaluate_buckets([b], [dev])
        out.append(float(np.sqrt(np.mean((pred - y) ** 2))) + l2)
    if wrapper is not None:
        trainer.forward_eval = wrapper
    for c, n in zip(counters, saved):
        c.launches = n
    return out


def trace_passes(trainer, buckets):
    """Record every bucket's loss without dropout as each pass over one
    bucket begins (``epoch_plan`` is called once per pass); returns the
    list of (epoch, bucket, losses) it fills."""
    passes, plan = [], trainer.epoch_plan

    def traced(epoch, bucket, n_rows, batch_size):
        passes.append((epoch, bucket, bucket_losses(trainer, buckets)))
        return plan(epoch, bucket, n_rows, batch_size)

    trainer.epoch_plan = traced
    return passes


def check_passes(label, passes, final, failures, phase="phase 5"):
    """Prints what every pass did to every bucket's loss without dropout
    and, unless ``failures`` is None, holds each pass to lowering the loss
    of its own bucket."""
    ends = [p[2] for p in passes[1:]] + [final]
    for (epoch, bucket, before), after in zip(passes, ends):
        moves = ", ".join(f"bucket {j} {x:.6f} -> {y:.6f}"
                          for j, (x, y) in enumerate(zip(before, after)))
        print(f"{phase} {label}: epoch {epoch} pass over bucket {bucket}: {moves}", flush=True)
        if failures is not None and not (np.isfinite(after[bucket])
                                         and after[bucket] < before[bucket]):
            failures.append(f"{label}: the pass over bucket {bucket} in epoch {epoch} did not "
                            f"lower its loss: {before[bucket]} -> {after[bucket]}")


def phase5(qm9_model, failures, card):
    """Train 2 epochs through Scann at QM9 width on synthetic QM9-like
    molecules, in the flagship recipe's two buckets (the main path, whose
    launches it returns), again with the plain step, and in one bucket."""
    import tempfile

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.data.synthetic import make_synthetic_dataset
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.train.loop import Trainer

    class PlainTrainer(Trainer):
        """The same Trainer with the backward kernel's plain version."""

        def raw_grads(self, batch, y, seed):
            pred, raw = kbwd.reference_fused_scann_train_grads(
                self.params, batch, y, self.config.model, self.mrelu_head,
                self.dropout_rate, seed)
            return pred[:, 0], raw

    work = tempfile.mkdtemp(prefix="scann_chip_smoke_")
    t0 = time.time()
    n_mol = 1000
    energy, nbr = make_synthetic_dataset(work, "qm9like", n_structures=n_mol, min_atoms=5,
                                         max_atoms=29, seed=0)
    print(f"phase 5: {n_mol} synthetic molecules (5-29 atoms of H, C, N, O, F) written and "
          f"featurized on the host in {time.time() - t0:.1f} s", flush=True)

    def config(name, max_buckets):
        return ScannConfig(model=qm9_model,
                           hyper=HyperConfig(batch_size=128, scheduler="sgdr", lr=5e-4,
                                             min_lr=1e-4, data_energy_path=energy,
                                             data_nei_path=nbr, epochs=2, seed=0,
                                             save_path=os.path.join(work, name)),
                           tpu=TpuConfig(max_buckets=max_buckets))

    # ---- the main path: the flagship recipe's buckets (max_buckets: 2) ----
    cfg = config("run", 2)
    scann = Scann(cfg, device="cuda")
    scann.prepare_dataset()
    buckets = scann.train_buckets
    steps = 2 * sum(-(-b.num_structures // 128) for b in buckets)
    eval_batches = (2 * sum(-(-b.num_structures // 128) for b in scann.valid_buckets)
                    + sum(-(-b.num_structures // 128) for b in scann.test_buckets))
    trainer = scann.trainer
    scann.init_params(cfg.hyper.seed)              # what fit() would draw
    passes = trace_passes(trainer, buckets)
    step_ms, fwd_calls = [], [0]
    train_step, forward_eval = trainer.train_step, trainer.forward_eval

    def timed_step(*args):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = train_step(*args)
        e.record()
        step_ms.append((s, e))
        return out

    def counted_eval(*args):
        fwd_calls[0] += 1
        return forward_eval(*args)

    trainer.train_step, trainer.forward_eval = timed_step, counted_eval
    kbwd.launch_scann_backward.launches = 0          # counts of the training path only
    kfwd.fused_scann_forward.launches = 0
    t1 = time.time()
    hist = scann.train()
    final = bucket_losses(trainer, buckets)        # before evaluate() restores "best"
    result = scann.evaluate()
    torch.cuda.synchronize()
    bwd_launches = kbwd.launch_scann_backward.launches
    fwd_launches = kfwd.fused_scann_forward.launches
    del trainer.train_step, trainer.forward_eval, trainer.epoch_plan
    med = statistics.median(s.elapsed_time(e) for s, e in step_ms)
    n_train = sum(b.num_structures for b in buckets)
    print(f"phase 5: buckets {[(b.shape, b.num_structures) for b in buckets]}, "
          f"{len(step_ms)} steps in {time.time() - t1:.1f} s, losses {hist['loss']}, "
          f"val_mae {hist['val_mae']}, test {result}", flush=True)
    print(f"phase 5: median train step {med:.4f} ms (CUDA events), epoch 2 "
          f"{n_train / hist['epoch_time'][1]:.1f} structures/s (the per-pass probes "
          f"included); backward launches "
          f"{bwd_launches} for {steps} steps, forward launches {fwd_launches} for "
          f"{eval_batches} eval batches  [{card}]", flush=True)
    if not all(np.isfinite(hist["loss"])):
        failures.append(f"training loss not finite: {hist['loss']}")
    # An epoch trains its buckets one after the other (as the JAX Trainer
    # does), so the loss that falls is that of the bucket being trained.
    check_passes("kernel", passes, final, failures)
    if bwd_launches != steps or len(step_ms) != steps:
        failures.append(f"backward launches {bwd_launches} != training steps {steps}")
    if fwd_launches != eval_batches or fwd_calls[0] != eval_batches:
        failures.append(f"forward launches {fwd_launches} != eval batches {eval_batches}")

    # ---- the same run with the plain step: the same losses -------------------
    plain = PlainTrainer(cfg, "cuda", os.path.join(work, "plain"))
    plain.init_state(cfg.hyper.seed)
    plain_passes = trace_passes(plain, buckets)
    plain_hist = plain.fit(buckets, scann.valid_buckets, log_fn=lambda *_: None)
    plain_final = bucket_losses(plain, buckets)
    check_passes("plain", plain_passes, plain_final, failures)
    mine = hist["loss"] + [x for p in passes for x in p[2]] + final
    ref = plain_hist["loss"] + [x for p in plain_passes for x in p[2]] + plain_final
    rel = max(abs(a - b) / abs(b) for a, b in zip(mine, ref))
    print(f"phase 5: the plain step's run: losses {plain_hist['loss']}; its epoch and "
          f"per-pass losses against the kernel's: max rel {rel:.3e} (limit "
          f"{TRAIN_RTOL})", flush=True)
    if len(mine) != len(ref) or not rel <= TRAIN_RTOL:
        failures.append(f"kernel and plain two-epoch runs differ: {rel:.3e}")

    # 3 steps through the kernel against 3 through the plain step
    b = buckets[-1]
    losses = []
    for cls in (Trainer, PlainTrainer):
        t = cls(cfg, "cuda", os.path.join(work, cls.__name__))
        t.init_state(5)
        (binputs, btargets), = t._put_buckets([b], "train")
        idx, seeds = t.epoch_plan(0, 0, b.num_structures, 128)
        run = []
        for k in range(3):
            rows = idx[k % idx.shape[0]].cuda()
            loss, _ = t.train_step({n: v[rows] for n, v in binputs.items()}, btargets[rows],
                                   5e-4, seeds[k % len(seeds)])
            run.append(float(loss))
        losses.append(run)
    rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    print(f"phase 5: 3 kernel steps {losses[0]} vs 3 plain steps {losses[1]}: "
          f"max rel {rel:.3e} (limit {LOSS_RTOL})", flush=True)
    if not rel <= LOSS_RTOL:
        failures.append(f"kernel and plain training steps differ: {rel:.3e}")

    # a model loaded back from the run directory predicts what the trainer does
    p_trained = scann.predict_data(scann.test_buckets)
    loaded = Scann.load_model_infer(trainer.workdir, device="cuda")
    p_loaded = loaded.predict_data(scann.test_buckets)
    d = float(np.abs(p_trained - p_loaded).max())
    print(f"phase 5: load_model_infer predicts {len(p_loaded)} test molecules, max |d| "
          f"{d:.3e} from the trainer's predictions", flush=True)
    if not (np.isfinite(p_loaded).all() and d <= ATOL + RTOL * np.abs(p_trained).max()):
        failures.append(f"load_model_infer predictions differ by {d:.3e}")

    # ---- one bucket: the epoch loss and the training-set loss fall -----------
    one = Scann(config("one", 1), device="cuda")
    one.prepare_dataset()
    one.init_params(0)
    before = bucket_losses(one.trainer, one.train_buckets)
    one_hist = one.train()
    after = bucket_losses(one.trainer, one.train_buckets)
    n_one = sum(b.num_structures for b in one.train_buckets)
    print(f"phase 5 one bucket {[b.shape for b in one.train_buckets]}: epoch losses "
          f"{one_hist['loss']}, training-set loss without dropout {before[0]:.6f} -> "
          f"{after[0]:.6f}, epoch 2 {n_one / one_hist['epoch_time'][1]:.1f} structures/s  "
          f"[{card}]", flush=True)
    if not (all(np.isfinite(one_hist["loss"])) and one_hist["loss"][-1] < one_hist["loss"][0]
            and np.isfinite(after[0]) and after[0] < before[0]):
        failures.append(f"one-bucket training loss not finite and falling: epochs "
                        f"{one_hist['loss']}, training set without dropout {before} -> {after}")
    return bwd_launches, {"data": (energy, nbr), "work": work, "step_ms": med,
                          "structures_s": n_train / hist["epoch_time"][1], "name": "phase 5"}


def train_packed(label, cfm, info, capacity, epochs, batch_size, want_routes, failures, card,
                 neighbors_multiple=8, compare_unpacked=False):
    """Structure packing on a training path: ``epochs`` epochs through
    ``Scann.prepare_dataset -> train -> evaluate -> predict_data`` with
    ``tpu.structure_packing`` at ``capacity`` rows a slot (None: derived from
    the largest structure), up to 8 segments a slot, on a featurized set of
    an earlier phase. Checks the routes (eval, step), one launch of the
    step's kernel per step and of the eval kernel per eval batch and none of
    the others, a finite loss that falls over more than one epoch and, with
    ``compare_unpacked``, that ``predict_data`` per structure equals the
    unpacked pipeline's with the same parameters. Returns the launches by
    kernel."""
    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop

    energy, nbr = info["data"]
    target = "formation_energy_per_atom" if cfm.n_atoms > 10 else "homo"

    def config(name, packed):
        return ScannConfig(model=cfm,
                           hyper=HyperConfig(batch_size=batch_size, scheduler="sgdr", lr=5e-4,
                                             min_lr=1e-4, target=target, data_energy_path=energy,
                                             data_nei_path=nbr, epochs=epochs, seed=0,
                                             save_path=os.path.join(info["work"], name)),
                           tpu=TpuConfig(max_buckets=2, structure_packing=packed,
                                         packing_capacity=capacity, pack_max_segments=8,
                                         neighbors_pad_multiple=neighbors_multiple))

    scann = Scann(config(label.replace(" ", "_"), True), device="cuda")
    scann.prepare_dataset()
    (b,) = scann.train_buckets
    M, N = b.shape
    S = b.num_segments
    trainer = scann.trainer
    routes = (trainer.eval_route(M, N, S), trainer.train_route(M, N, S))
    scann.init_params(0)
    step_ms = []
    train_step = trainer.train_step

    def timed_step(*args):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = train_step(*args)
        e.record()
        step_ms.append((s, e))
        return out

    trainer.train_step = timed_step
    counters = {"scann_forward": kfwd.fused_scann_forward,
                "scann_backward": kbwd.launch_scann_backward,
                "scann_loop": kloop.launch_loop_forward,
                "scann_loop_backward": kloop.launch_loop_backward,
                "local_attention": kla.fused_local_attention}
    for c in counters.values():
        c.launches = 0                               # counts of this packed path only
    hist = scann.train()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    del trainer.train_step
    slot_bs = trainer._slot_batch
    steps = epochs * -(-len(b.targets) // slot_bs)
    evals = epochs * sum(-(-len(v.targets) // slot_bs) for v in scann.valid_buckets)
    result = scann.evaluate()
    med = statistics.median(s.elapsed_time(e) for s, e in step_ms)
    per_s = b.num_structures / hist["epoch_time"][-1]
    print(f"{label}: {b.num_structures} structures in {b.num_slots} slots of {M} rows "
          f"({b.occupancy:.1%} occupancy, S={S}), N={N}, slot batch {slot_bs} (batch_size "
          f"{batch_size} structures); routes eval {routes[0]}, step {routes[1]}; losses "
          f"{hist['loss']}, val_mae {hist['val_mae']}, test {result}", flush=True)
    print(f"{label}: median train step {med:.4f} ms (CUDA events), last epoch {per_s:.1f} "
          f"structures/s; unpacked ({info['name']}): median step {info['step_ms']:.4f} ms, "
          f"epoch 2 {info['structures_s']:.1f} structures/s; launches {launches} for {steps} "
          f"steps and {evals} eval batches  [{card}]", flush=True)
    eval_kernel = {"fused": "scann_forward", "loop": "scann_loop"}.get(routes[0])
    step_kernel = {"fused": "scann_backward", "loop": "scann_loop_backward"}.get(routes[1])
    expect = {k: 0 for k in counters}
    if eval_kernel:
        expect[eval_kernel] += evals
    if step_kernel:
        expect[step_kernel] += steps
    if routes != want_routes or launches != expect or len(step_ms) != steps:
        failures.append(f"{label}: routes {routes} (want {want_routes}), launches {launches} "
                        f"(want {expect}), {len(step_ms)} timed steps for {steps}")
    if not (all(np.isfinite(hist["loss"])) and (epochs == 1 or hist["loss"][-1] < hist["loss"][0])):
        failures.append(f"{label}: training loss not finite and falling: {hist['loss']}")
    if compare_unpacked:
        got, got_ga = scann.predict_data(scann.test_buckets, with_ga=True)
        plain = Scann(config(label.replace(" ", "_") + "_unpacked", False), device="cuda")
        plain.prepare_dataset()
        plain.trainer.load_params(scann.params)
        want, want_ga = plain.predict_data(plain.test_buckets, with_ga=True)
        d = float(np.abs(got - want).max())
        d_ga = max(float(np.abs(g - w).max()) for g, w in zip(got_ga, want_ga))
        ok = (got.shape == want.shape and np.isfinite(got).all()
              and np.all(np.abs(got - want) <= ATOL + RTOL * np.abs(want))
              and all(g.shape == w.shape and np.all(np.abs(g - w) <= ATOL + RTOL * np.abs(w))
                      for g, w in zip(got_ga, want_ga)))
        print(f"{label}: predict_data of {len(got)} test structures packed against unpacked, "
              f"same parameters: max |d| {d:.3e}, GA scores {d_ga:.3e} (rtol {RTOL}, atol "
              f"{ATOL})", flush=True)
        if not ok:
            failures.append(f"{label}: packed predictions differ from unpacked: {d:.3e}, "
                            f"ga {d_ga:.3e}")
    return launches


def operations_ms(flops, fp32_flops, rates=None):
    """The least time of ``flops``: ``fp32_flops`` of them at the FP32 rate
    outside the tensor cores and the rest as split-TF32 products, three TF32
    passes each at the dense TF32 rate; at the published rates, or at
    ``rates`` (``measure_device_rates``'s) when given."""
    if rates is None:
        fp32, tf32 = published_rates()[:2]
    else:
        fp32, tf32 = rates["fp32_tflops"] * 1e12, rates["tf32_tflops"] * 1e12
    return 1e3 * (3 * (flops - fp32_flops) / tf32 + fp32_flops / fp32)


def bound_ms(flops, nbytes, fp32_flops):
    """(bound, "operations" | "bytes", measured bound): the larger of the
    operations' time (``operations_ms``) and the HBM time of one pass over
    inputs and outputs, at the published rates; the same at the rates the
    roofline phase measured (None before it ran)."""
    ops_ms = operations_ms(flops, fp32_flops)
    bytes_ms = 1e3 * nbytes / published_rates()[2]
    measured = None
    if MEASURED:
        measured = max(operations_ms(flops, fp32_flops, MEASURED),
                       1e3 * nbytes / (MEASURED["hbm_gbps"] * 1e9))
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", measured


def tensor_bytes(*groups):
    return sum(t.numel() * t.element_size() for g in groups for t in g if t is not None)


def hold(label, named, failures):
    """Print one line of max abs errors for (what, got, want, atol) and
    record what falls outside rtol/atol; returns the largest error."""
    line, worst = [label], 0.0
    for what, got, want, atol in named:
        diff = (got - want).abs()
        ok = (bool((diff <= atol + RTOL * want.abs()).all())
              and bool(torch.isfinite(got).all()))
        ab = diff.max().item()
        worst = max(worst, ab)
        line.append(f"{what} {ab:.2e}")
        if not ok:
            failures.append(f"{label} {what}: max_abs {ab:.3e} outside rtol {RTOL} atol {atol}")
    print("  ".join(line), flush=True)
    return worst


def crystal_models():
    """configs/model_mp2018.yaml and configs/model_ptgp.yaml, model blocks."""
    from scann_tpu_torch.config import ModelConfig

    wide = dict(local_dim=128, num_head=8, global_dim=128, dense_out=128, scale=0.5,
                use_attn_norm=True, use_ga_norm=True)
    mp2018 = ModelConfig(n_atoms=95, embedding_dim=128, n_attention=9, use_ring=False,
                         g_update=True, gaussian_d=6.0, **wide)
    ptgp = ModelConfig(n_atoms=80, embedding_dim=48, n_attention=11, use_ring=True,
                       g_update=False, gaussian_d=4.0, **wide)
    return mp2018, ptgp


def hold_loop_forward(label, cfm, p, x, failures, mrelu=False, rate=0.0, clusters=None,
                      relaunches=0):
    """Hold the crystal loop-forward kernel against its plain version on one
    batch, at every cluster size of ``clusters`` (blocks per structure; the
    wrapper's own choice for this batch size when None, through the public
    entry point). With ``relaunches``, that many further launches run at each
    cluster size on a kept scratch (geometry and new centers) filled with NaN
    before one launch and with a finite constant before the next: each must
    return the first launch's pred and ga bit for bit. Returns the largest
    absolute difference from the plain version."""
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop

    B, M = x["atom_mask"].shape[:2]
    N = x["neighbors"].shape[2]
    chunk_atoms, block, _, _ = kloop.loop_memory_plan(cfm, M, N, kfwd.segment_count(x))
    own = kloop.cluster_size(B)
    packed = kfwd.pack_params(p, cfm)
    with torch.inference_mode():
        pred0, ga0 = kloop.reference_loop_forward(p, x, cfm, mrelu, rate, 11)
    worst = 0.0
    for C in clusters or (own,):
        tag = (f"{label} B={B} M={M} N={N}{packed_label(x)} (atom block {block}, "
               f"{chunk_atoms} per chunk, {C} blocks per structure) dropout {rate}")
        with torch.inference_mode():
            if C == own:    # through the public entry point, which chooses C itself
                pred, ga = kloop.loop_scann_forward(p, x, cfm, mrelu, rate, 11)
            else:
                pred, ga = kloop._launch(packed, x, cfm, mrelu, rate, 11, 0, C)
            torch.cuda.synchronize()
        worst = max(worst, hold(tag, [("pred", pred, pred0, ATOL), ("ga", ga, ga0, ATOL)],
                                failures))
        if relaunches:
            scratch = kloop.loop_forward_scratch(cfm, B, M, N, "cuda")
            differ = set()
            with torch.inference_mode():
                for i in range(relaunches):
                    for t in scratch.values():
                        if t is not None:
                            t.fill_(float("nan") if i % 2 == 0 else -3.0)
                    p_i, g_i = kloop._launch(packed, x, cfm, mrelu, rate, 11, 0, C, scratch)
                    differ |= {w for w, a, b in (("pred", p_i, pred), ("ga", g_i, ga))
                               if not torch.equal(a, b)}
            print(f"{tag}: {relaunches} launches on NaN- and constant-filled scratch "
                  f"bit-identical: {not differ}", flush=True)
            if differ:
                failures.append(f"{tag}: launches on the same inputs differ in {sorted(differ)}")
    return worst


def time_loop_forward(name, cfm, x, card, clusters=(None,)):
    """Kernel #3 at one batch shape, at each cluster size of ``clusters`` (None:
    the wrapper's own), in turns with its plain version (plain, kernel,
    kernel, plain), against its bound: the larger of the operations' time
    (``operations_ms``) and the HBM time of the inputs, weights and outputs
    read or written once plus the geometry scratch's round trips
    (``loop_forward_bytes``)."""
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    params = init_params(cfm, torch.Generator().manual_seed(0), "cuda")
    packed = kfwd.pack_params(params, cfm)
    B, M = x["atom_mask"].shape[:2]
    N = x["neighbors"].shape[2]
    flops = kloop.loop_forward_flops(cfm, B, M, N)
    nbytes = (tensor_bytes(x.values(), packed.values()) + 4 * (B + B * M)
              + kloop.loop_forward_bytes(cfm, B, M, N))
    bound, by, measured = bound_ms(flops, nbytes, kfwd.forward_fp32_flops(cfm, B, M, N))
    scratch = kloop.loop_forward_scratch(cfm, B, M, N, "cuda")
    out = {}
    with torch.inference_mode():
        kloop.check_supported(cfm, M, N)
        kfwd._check_inputs(x, cfm, packed["wde"].device)
        for C in clusters:
            C = kloop.cluster_size(B) if C is None else C
            ms, plain_ms = in_turns_ms(
                lambda: kloop.reference_loop_forward(params, x, cfm),
                lambda: kloop._launch(packed, x, cfm, False, 0.0, 0, 0, C, scratch), 3, 10)
            print(f"scann_loop at {name} B={B} M={M} N={N} L={cfm.n_attention} (timed in turns: "
                  f"plain, kernel, kernel, plain): kernel {ms:.4f} ms on {B} clusters of {C} "
                  f"blocks ({kloop.max_active_forward_clusters(cfm, B, M, N, C)} such clusters "
                  f"run at once), plain {plain_ms:.4f} ms, {flops:.4e} FLOP, {nbytes} bytes, "
                  f"bound {bound:.4f} ms by {by} ({100 * bound / ms:.1f}% of it reached)  "
                  f"[{card}]", flush=True)
            out[C] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                      "measured_bound_ms": measured, "flops": flops, "cluster": C}
    return out


def phase6(matrix, mp2018, ptgp, mp_packed, failures, card):
    """The crystal loop-forward kernel against its plain version at 1, 2 and
    4 blocks per structure (a small matrix at dropout 0 and 0.1, two atoms
    per chunk, a one-atom structure, fewer atoms than blocks, a ragged
    M = 160 at B <= 28, atom blocks of 16 at M = 200, the gate's edge
    M = 237, MP2018 at B = 64 and 128, Pt/graphene), with relaunches on
    garbage-filled scratch held bit for bit, then its time. Returns (largest
    abs error, timing of the MP2018 shape)."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(6)
    worst = 0.0
    every = kloop.CLUSTER_SIZES[::-1]      # (1, 2, 4)

    def compare(name, cfm, x, mrelu=False, rate=0.0, clusters=every, relaunches=0):
        nonlocal worst
        p = init_params(cfm, torch.Generator().manual_seed(6), "cuda")
        worst = max(worst, hold_loop_forward(f"phase 6 {name}", cfm, p, x, failures, mrelu, rate,
                                             clusters, relaunches))

    cases = list(matrix) + [("scann+ use_drop", dataclasses.replace(matrix[0][1], use_drop=True),
                             False)]
    for name, cfm, mrelu in cases:
        # M=40: an atom block of 32 and one of 8 at one block per structure, shares of 20
        # and 10 at 2 and 4; single-atom structures allowed
        x = synthetic_batch(rng, 6, 40, 8, cfm.use_ring, cfm.feature == "cgcnn", min_atoms=1)
        compare(name, cfm, x, mrelu, 0.0)
        compare(name, cfm, x, mrelu, 0.1, relaunches=2)
    compare("scann+ two atoms per chunk", matrix[0][1], synthetic_batch(rng, 4, 72, 24))
    lone = synthetic_batch(rng, 4, 72, 8)
    lone["atom_mask"][0] = 0.0
    lone["atom_mask"][0, 0] = 1.0
    lone["neighbor_mask"][0] = 0.0
    compare("scann+ one-atom structure", matrix[0][1], lone, relaunches=2)
    # M=3 at 4 blocks per structure: the last block has no atom
    compare("scann+ fewer atoms than blocks", matrix[0][1],
            synthetic_batch(rng, 4, 3, 8, min_atoms=1), rate=0.1, relaunches=2)
    # a small batch (4 blocks per structure) of a ragged bucket, atom blocks of 16
    # (M 189 to 221) and the gate's edge (blocks of 8)
    compare("mp2018 full width, ragged", mp2018,
            synthetic_batch(rng, 20, 160, 32, n_atoms=mp2018.n_atoms), rate=0.1, relaunches=4)
    compare("mp2018 full width, atom blocks of 16", mp2018,
            synthetic_batch(rng, 4, 200, 32, n_atoms=mp2018.n_atoms, min_atoms=150),
            relaunches=4)
    compare("mp2018 full width, the gate's edge", mp2018,
            synthetic_batch(rng, 4, 237, 32, n_atoms=mp2018.n_atoms, min_atoms=150),
            relaunches=4)
    mp_inputs = synthetic_batch(rng, 64, 96, 32, n_atoms=mp2018.n_atoms, min_atoms=20)
    compare("mp2018 full width", mp2018, mp_inputs, clusters=(1, 2), relaunches=4)
    twice = {k: torch.cat([v, v]) for k, v in mp_inputs.items()}
    compare("mp2018 full width", mp2018, twice, clusters=(1,))
    ptgp_inputs = synthetic_batch(rng, 64, 128, 32, use_ring=True, n_atoms=ptgp.n_atoms,
                                  min_atoms=20)
    compare("ptgp full width", ptgp, ptgp_inputs, clusters=(1, 2), relaunches=4)
    # packed slots: the small matrix in slots of 16 rows, and MP2018-like crystals of
    # 20-90 sites at packing capacity 96, up to 8 segments a slot, at 1, 2 and 4 blocks
    prng = np.random.default_rng(60)
    for name, cfm, mrelu in matrix:
        compare(f"{name}", cfm, pack_batch(synthetic_batch(prng, 12, 8, 8, cfm.use_ring,
                                                           cfm.feature == "cgcnn"), 16),
                mrelu, 0.1, relaunches=2)
    compare("mp2018 full width capacity 96", mp2018, mp_packed, relaunches=4)

    mp = time_loop_forward("mp2018", mp2018, mp_inputs, card, clusters=(2, 1))
    timing = dict(mp[2], ms_one_block=mp[1]["ms"])
    (doubled,) = time_loop_forward("mp2018, the batch doubled", mp2018, twice, card).values()
    (pt,) = time_loop_forward("ptgp", ptgp, ptgp_inputs, card).values()
    timing.update(ms_batch_doubled=doubled["ms"], ms_ptgp=pt["ms"], plain_ms_ptgp=pt["plain_ms"],
                  bound_ms_ptgp=pt["bound_ms"])
    (pk,) = time_loop_forward("mp2018 capacity 96" + packed_label(mp_packed), mp2018, mp_packed,
                              card).values()
    timing["packed"] = {k: pk[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "measured_bound_ms", "flops")}
    print(f"scann_loop at mp2018: B=128 ({doubled['cluster']} block per structure) takes "
          f"{doubled['ms'] / timing['ms']:.2f}x the time of B=64 ({timing['cluster']} blocks per "
          f"structure) for twice the work; one block per structure at B=64 "
          f"{timing['ms_one_block'] / timing['ms']:.2f}x  [{card}]", flush=True)
    at_once = {c: kloop.max_active_forward_clusters(mp2018, 64, 96, 32, c) for c in every}
    print(f"scann_loop clusters that run at once at the MP2018 shape, by blocks per structure: "
          f"{at_once} (the wrapper's rule counts on {kloop.CLUSTERS_AT_ONCE}; fewer would cost "
          f"a second wave, not the result)", flush=True)
    print(f"phase 6: worst loop-forward abs error {worst:.3e}  [{card}]", flush=True)
    return worst, timing


def layer_inputs(rng, B, M, N, D, H, g_update, K=20):
    """Seeded inputs and parameters of one LocalAttention layer, on the card."""
    from scann_tpu_torch.kernels.local_attention import PARAM_KEYS

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    mask = (rng.uniform(size=(B, M, N)) > 0.25).astype(np.float32)
    mask[..., 0] = 1.0
    shapes = {"filter_geo/kernel": (3 * D if g_update else K, D), "key/kernel": (D, D),
              "query/kernel": (D, D)}
    params = {}
    for key in PARAM_KEYS[: 10 if g_update else 8]:
        shape = shapes.get(key, (D,))
        params[key] = f32(rng.uniform(0.5, 1.5, size=shape) if key.endswith("scale")
                          else 0.1 * rng.normal(size=shape))
    return (f32(rng.normal(size=(B, M, D))),
            torch.from_numpy(rng.integers(0, M, size=(B, M, N)).astype(np.int32)).cuda(),
            f32(rng.normal(size=(B, M, N, D if g_update else K))), f32(mask),
            f32(rng.uniform(0.3, 3.0, size=(B, M, N))), params, H, 0.5, g_update)


def time_local_attention(args, card):
    """Kernel #5 on one layer's inputs, in turns with its plain version
    (plain, kernel, kernel, plain), against its bound: the products as three
    TF32 passes and ``layer_fp32_flops`` at the FP32 rate, or one pass over
    inputs and outputs at the HBM rate."""
    from scann_tpu_torch.kernels import local_attention as kla

    centers, idx, geometry, mask, weight, params, H, _, g_update = args
    B, M, D = centers.shape
    N = idx.shape[2]
    flops = kla.layer_flops(B, M, N, D, g_update, geometry.shape[-1])
    nbytes = (tensor_bytes([centers, idx, geometry, mask, None if g_update else weight],
                           params.values())
              + 4 * (centers.numel() + B * M * N * H + (geometry.numel() if g_update else 0)))
    bound, by, measured = bound_ms(flops, nbytes, kla.layer_fp32_flops(B, M, N, D))
    with torch.inference_mode():
        ms, plain_ms = in_turns_ms(lambda: kla.reference_local_attention(*args),
                                   lambda: kla._launch(*args), 3, 10)
        b2b = back_to_back_ms(lambda: kla._launch(*args))
    block = kla.make_plan(B, M, N, D, H, g_update, kla.sm_count(centers.device))[0]
    print(f"local_attention ({'scann+' if g_update else 'scann'}) at B={B} M={M} N={N} D={D} "
          f"(atom block {block}; timed in turns: plain, kernel, kernel, plain): kernel "
          f"{ms:.4f} ms ({b2b:.4f} ms a launch back to back), plain {plain_ms:.4f} ms, "
          f"{flops:.4e} FLOP, {nbytes} bytes, bound {bound:.4f} ms by {by} "
          f"({100 * bound / ms:.1f}% of it reached)  [{card}]", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "flops": flops,
            "measured_bound_ms": measured, "ms_back_to_back": b2b}


def phase7(mp2018, failures, card):
    """The per-layer LocalAttention kernel against its plain version at a
    ragged small layer, an M beyond the loop kernel's gate and one MP2018
    layer (SCANN+ and SCANN), each relaunched into outputs filled with NaN
    that must come back bit for bit; its time at the last two shapes; the
    per-layer model against the eager model. Returns (largest abs error,
    timing at the MP2018 layer, SCANN+, with the other three beside it)."""
    import dataclasses

    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.models.scann import check_index_ranges, init_params, scann_forward

    rng = np.random.default_rng(7)
    worst, times = 0.0, {}
    D, H = mp2018.local_dim, mp2018.num_head
    for g_update in (True, False):
        what = "scann+" if g_update else "scann"
        # a ragged small layer, an M beyond the loop kernel's gate, one MP2018 layer
        for B, M, N, d, h in ((3, 40, 8, 32, 4), (8, 256, 32, D, H), (64, 96, 32, D, H)):
            args = layer_inputs(rng, B, M, N, d, h, g_update)
            kla.check_neighbor_range(*kla.index_bounds(args[1]), M)   # the wrapper reads nothing
            with torch.inference_mode():
                out, geo, attn = kla.fused_local_attention(*args)
                torch.cuda.synchronize()
                out0, geo0, attn0 = kla.reference_local_attention(*args)
                kept = tuple(None if t is None else torch.full_like(t, float("nan"))
                             for t in (out, geo if g_update else None, attn))
                again = kla._launch(*args, outputs=kept)
                torch.cuda.synchronize()
            named = [("out", out, out0, ATOL), ("attn", attn, attn0, ATTN_ATOL)]
            if g_update:
                named.append(("geometry", geo, geo0, ATOL))
            tag = f"phase 7 layer {what} B={B} M={M} N={N} D={d}"
            worst = max(worst, hold(tag, named, failures))
            differ = [w for w, a, b in zip(("out", "geometry", "attn"), again,
                                           (out, geo if g_update else None, attn))
                      if a is not None and not torch.equal(a, b)]
            print(f"{tag}: a relaunch into NaN-filled outputs bit-identical: {not differ}",
                  flush=True)
            if differ:
                failures.append(f"{tag}: a relaunch into NaN-filled outputs differs in {differ}")
            if M > 40:
                times[(what, M)] = time_local_attention(args, card)
    timing = dict(times[("scann+", 96)])
    for (what, M), t in times.items():
        if (what, M) != ("scann+", 96):
            suffix = ("_scann" if what == "scann" else "") + ("_m256" if M == 256 else "")
            timing.update({f"{k}{suffix}": t[k]
                           for k in ("ms", "plain_ms", "bound_ms", "ms_back_to_back")})

    # the per-layer model (what use_attn_norm: false and oversize structures run)
    for g_update in (True, False):
        cfm = dataclasses.replace(mp2018, use_attn_norm=False, n_attention=3, g_update=g_update)
        x = synthetic_batch(rng, 8, 96, 32, n_atoms=cfm.n_atoms, min_atoms=20)
        p = init_params(cfm, torch.Generator().manual_seed(7), "cuda")
        check_index_ranges(x, cfm)
        before = kla.fused_local_attention.launches
        with torch.inference_mode():
            pred, ga = scann_forward(p, x, cfm, use_pallas=True)
            torch.cuda.synchronize()
            pred0, ga0 = scann_forward(p, x, cfm)
        n = kla.fused_local_attention.launches - before
        worst = max(worst, hold(f"phase 7 per-layer model use_attn_norm=False "
                                f"{'scann+' if g_update else 'scann'} ({n} launches)",
                                [("pred", pred, pred0, ATOL), ("ga", ga, ga0, ATOL)], failures))
        if n != cfm.n_attention:
            failures.append(f"per-layer model launched the layer kernel {n} times for "
                            f"{cfm.n_attention} layers")
    print(f"phase 7: worst per-layer abs error {worst:.3e}  [{card}]", flush=True)
    return worst, timing


def phase_rates(qm9_model, failures, card):
    """Phase 11 (run first): the card's rates by the probes of
    ``csrc/roofline_probe.cu`` (``utils.roofline.measure_device_rates``,
    measured anew), each beside its published peak; a rate over
    ``RATE_LIMIT`` x its peak means a probe is wrong and fails. Fills
    ``MEASURED``, which every later bound is also taken at, and prints the
    step ceilings of the QM9 and MP2018 training shapes."""
    from scann_tpu_torch.utils.flops import peak_tflops
    from scann_tpu_torch.utils.roofline import measure_device_rates, step_ceiling

    t0 = time.time()
    rates = measure_device_rates(use_cache=False)
    fp32, tf32, hbm, exp = published_rates()
    rows = [("expf on the special-function units", rates["exp_per_s"], exp, "/s"),
            ("FP32 FMA on the CUDA cores (2 FLOP each)", 2 * rates["elem_per_s"], fp32, "FLOP/s"),
            ("TF32 mma.sync m16n8k8 on the tensor cores", rates["tf32_tflops"] * 1e12, tf32,
             "FLOP/s"),
            ("HBM stream over 1 GiB (read + write)", rates["hbm_gbps"] * 1e9, hbm, "bytes/s")]
    for what, got, peak, unit in rows:
        print(f"phase 11 rate: {what}: {got:.4e} {unit}, {100 * got / peak:.1f}% of the "
              f"published {peak:.4e}", flush=True)
        if not got > 0 or got > RATE_LIMIT * peak:
            failures.append(f"phase 11: measured {what} {got:.4e} {unit} is not within "
                            f"(0, {RATE_LIMIT} x {peak:.4e}]: the probe is wrong")
    print(f"phase 11: rates measured in {time.time() - t0:.1f} s on {rates['device_kind']}, SM "
          f"clock {rates['sm_clock_mhz']} MHz under the HBM stream, power limit "
          f"{rates['power_limit_w']} W  [{card}]", flush=True)
    MEASURED.update(rates)
    mp2018 = crystal_models()[0]
    for name, cfm, M, N, B in (("QM9", qm9_model, 32, 16, 128), ("MP2018", mp2018, 96, 32, 64)):
        for training in (True, False):
            c = step_ceiling(cfm, M, N, B, rates=rates, training=training,
                             peak_tflops_override=peak_tflops(H100))
            print(f"phase 11 ceiling {name} ({M}, {N}) B={B} "
                  f"{'training' if training else 'forward'}: tensor {c['t_tensor_us']:.3f} us, "
                  f"CUDA cores {c['t_cuda_cores_us']:.3f} us, HBM {c['t_hbm_us']:.3f} us a "
                  f"structure; bound by {c['binding_engine']}: {c['structs_per_s']:.1f} "
                  f"structures/s (serial {c['structs_per_s_serial']:.1f}), MFU ceiling "
                  f"{c['mfu_ceiling']:.4f} of {peak_tflops(H100)} TFLOP/s TF32", flush=True)
    return rates


def phase_featurizers(failures, card):
    """Phase 12: the Voronoi featurizer of the dataset and serving paths
    (``data/featurize.featurize_record``) by the native path
    (``native/voronoi_cell.cc``, the default) and by the scipy/Qhull path
    (``SCANN_TPU_NATIVE_VORONOI=0``) on the same structures: the first 48
    MP2018-like crystals of phase 10's set (20-90 sites), the 6 crystals
    phase 8 serves (20-200 sites) and the first 128 QM9-like molecules of
    phase 5's set (5-29 atoms). Prints ms per structure on each path; the
    neighbour records must agree: species and index in the same order, the
    solid angles and distance to 1e-8. Returns {kind: (native ms, scipy ms)}."""
    from scann_tpu_torch.data import native, native_voronoi
    from scann_tpu_torch.data.featurize import featurize_record
    from scann_tpu_torch.data.synthetic import _random_crystal, _random_molecule

    t0 = time.time()
    native_voronoi.get_lib()
    native.get_lib()
    print(f"phase 12: built the host libraries (g++ -O3 -march=native) in "
          f"{time.time() - t0:.1f} s", flush=True)

    def crystal(sp, xyz, lat):
        return {"Atoms": sp, "Coords": xyz.astype(np.float32),
                "Lattice": lat.astype(np.float32), "Cartesian": True}

    rng = np.random.default_rng(0)                  # make_synthetic_dataset's draws
    sets = {"crystal": [], "molecule": []}
    for _ in range(48):
        sets["crystal"].append(crystal(*_random_crystal(rng, int(rng.integers(20, 91)))))
    rng = np.random.default_rng(8)                  # phase 8's crystals
    sets["served crystal"] = [crystal(*_random_crystal(rng, n))
                              for n in (20, 37, 54, 71, 90, 200)]
    rng = np.random.default_rng(0)
    for _ in range(128):
        sp, xyz = _random_molecule(rng, int(rng.integers(5, 30)))
        sets["molecule"].append({"Atoms": sp, "Coords": xyz.astype(np.float32)})

    old = os.environ.get("SCANN_TPU_NATIVE_VORONOI")
    out = {}
    try:
        for kind, recs in sets.items():
            got = {}
            for path, flag in (("native", "1"), ("scipy", "0")):
                os.environ["SCANN_TPU_NATIVE_VORONOI"] = flag
                t = time.perf_counter()
                got[path] = [featurize_record(r) for r in recs]
                got[path + " ms"] = 1e3 * (time.perf_counter() - t) / len(recs)
            bad = 0
            for a, b in zip(got["native"], got["scipy"]):
                same = len(a) == len(b) and all(
                    [(r[0], r[1]) for r in x] == [(r[0], r[1]) for r in y]
                    and all(abs(p - q) <= 1e-8 for r, u in zip(x, y) for p, q in zip(r[2:], u[2:]))
                    for x, y in zip(a, b))
                bad += not same
            sites = [len(r["Atoms"]) for r in recs]
            print(f"phase 12 {kind}s ({len(recs)}, {min(sites)}-{max(sites)} sites): native "
                  f"{got['native ms']:.3f} ms a structure, scipy {got['scipy ms']:.3f} ms "
                  f"({got['scipy ms'] / got['native ms']:.1f}x); records differ in {bad} of "
                  f"{len(recs)}  [{card}]", flush=True)
            if bad:
                failures.append(f"phase 12: native and scipy Voronoi records differ in {bad} of "
                                f"{len(recs)} {kind}s")
            out[kind] = (got["native ms"], got["scipy ms"])
    finally:
        if old is None:
            os.environ.pop("SCANN_TPU_NATIVE_VORONOI", None)
        else:
            os.environ["SCANN_TPU_NATIVE_VORONOI"] = old
    return out


class ServingSpans:
    """Spans of one serving run (``utils.Timer``): host featurization
    (``Scann.featurize_structures``, on the featurizer thread) and pad +
    launch + read-back (``Scann.predict_featurized``, on the device thread),
    each ended by ``torch.cuda.synchronize()``; and, per device batch, when
    each began and ended, so that a request's wall time splits into queue
    wait (HTTP parse and the coalescing window), featurize, hand-off (the
    double buffer), pad/launch and the response. Batches are told apart by
    their structures' site counts."""

    def __init__(self, scann):
        from scann_tpu_torch.utils import Timer

        self.scann, self.timer, self.batches = scann, Timer(), []
        featurize, predict = scann.featurize_structures, scann.predict_featurized

        def timed_featurize(structs, **kw):
            t0 = time.perf_counter()
            with self.timer("featurize"):
                out = featurize(structs, **kw)
                torch.cuda.synchronize()
            self.batches.append({"sites": [len(s) for s in out[0]],
                                 "featurize": (t0, time.perf_counter())})
            return out

        def timed_predict(structs, all_inputs, **kw):
            t0 = time.perf_counter()
            with self.timer("pad_launch"):
                out = predict(structs, all_inputs, **kw)
                torch.cuda.synchronize()
            sites = [len(s) for s in structs]
            for b in reversed(self.batches):
                if b["sites"] == sites and "launch" not in b:
                    b["launch"] = (t0, time.perf_counter())
                    break
            return out

        scann.featurize_structures = timed_featurize
        scann.predict_featurized = timed_predict

    def close(self):
        del self.scann.featurize_structures, self.scann.predict_featurized

    def report(self, label, sent, card):
        """One line per request: ``sent`` maps name -> (site count, start,
        end) on ``time.perf_counter``'s clock."""
        for name, (n, start, end) in sent.items():
            b = next((b for b in self.batches if n in b["sites"] and "launch" in b), None)
            if b is None:
                print(f"{label} request {name}: no span (answered by the per-request "
                      "fallback)", flush=True)
                continue
            (f0, f1), (l0, l1) = b["featurize"], b["launch"]
            ms = lambda a, z: 1e3 * (z - a)
            print(f"{label} request {name} ({n} sites, batch of {len(b['sites'])}): wall "
                  f"{ms(start, end):.1f} ms = queue wait {ms(start, f0):.1f} + featurize "
                  f"{ms(f0, f1):.1f} + hand-off {ms(f1, l0):.1f} + pad/launch "
                  f"{ms(l0, l1):.1f} + response {ms(l1, end):.1f}  [{card}]", flush=True)
        print(f"{label} spans (Timer):\n  " + self.timer.summary().replace("\n", "\n  "),
              flush=True)


def cif_text(name, species, coords, lattice):
    """A P1 CIF of an orthorhombic cell with cartesian ``coords``."""
    abc = np.diag(lattice)
    rows = "".join(f"{s} {x:.6f} {y:.6f} {z:.6f}\n"
                   for s, (x, y, z) in zip(species, np.asarray(coords) / abc))
    return (f"data_{name}\n_cell_length_a {abc[0]:.6f}\n_cell_length_b {abc[1]:.6f}\n"
            f"_cell_length_c {abc[2]:.6f}\n_cell_angle_alpha 90.0\n_cell_angle_beta 90.0\n"
            "_cell_angle_gamma 90.0\nloop_\n_atom_site_type_symbol\n_atom_site_fract_x\n"
            "_atom_site_fract_y\n_atom_site_fract_z\n" + rows)


def phase8(mp2018, run_dir, failures, card):
    """The crystal serving path: PredictionServer over the MP2018 model that
    phase 10 trained, loaded from its run directory
    (``BatchedPredictor.from_model_dir``), synthetic periodic crystals posted
    as CIF and as JSON. Returns the launches of (the loop kernel, the
    per-layer kernel) on that path."""
    from scann_tpu_torch.data.cif import parse_cif
    from scann_tpu_torch.data.structure import Structure
    from scann_tpu_torch.data.synthetic import _random_crystal
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import scann_forward
    from scann_tpu_torch.serve import BatchedPredictor, PredictionServer

    counters = (kfwd.fused_scann_forward, kloop.launch_loop_forward, kla.fused_local_attention)
    for c in counters:
        c.launches = 0                               # counts of the serving path only
    t_serve = time.time()
    predictor = BatchedPredictor.from_model_dir(run_dir, max_batch=64, window_ms=20.0,
                                                warmup_shapes=[])
    scann = predictor.scann
    hyper = scann.config.hyper
    routes = []                                  # (route, M, N, B) of every device batch
    forward_eval = scann.trainer.forward_eval

    def recorded_forward(params, batch):
        B, M = batch["atomic"].shape[:2]
        N = batch["neighbors"].shape[2]
        routes.append((scann.trainer.eval_route(M, N), M, N, B))
        return forward_eval(params, batch)

    scann.trainer.forward_eval = recorded_forward
    print(f"crystal serving: warmed {scann.warmup_serving([(96, 32)])} at one structure",
          flush=True)
    rng = np.random.default_rng(8)
    crystals = {f"crystal{n}": _random_crystal(rng, n) for n in (20, 37, 54, 71, 90, 200)}
    bodies, sent = {}, {}
    for i, (name, (sp, xyz, lat)) in enumerate(crystals.items()):
        if i % 2 == 0:
            sent[name] = cif_text(name, sp, xyz, lat)
            bodies[name] = (sent[name].encode(), "text/plain")
        else:
            bodies[name] = (json.dumps({"structures": [{
                "species": sp, "coords": xyz.tolist(), "lattice": lat.tolist()}]}).encode(),
                            "application/json")

    spans = ServingSpans(scann)
    server = PredictionServer(predictor, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://{server.host}:{server.port}"
    answers, latencies, wall = {}, {}, {}

    def post(name, body, ctype):
        t = time.perf_counter()
        req = urllib.request.Request(base + "/predict", data=body,
                                     headers={"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                answers[name] = (r.status, json.loads(r.read()))
        except Exception as e:  # recorded, then reported as a failure below
            answers[name] = (getattr(e, "code", None), {"error": repr(e)})
        wall[name] = (len(crystals[name][0]), t, time.perf_counter())
        latencies[name] = 1e3 * (wall[name][2] - t)

    try:
        threads = [threading.Thread(target=post, args=(n, *b)) for n, b in bodies.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    finally:
        server.shutdown()
        thread.join(10)
    torch.cuda.synchronize()
    serve_s = time.time() - t_serve
    fused_n, loop_n, layer_n = (c.launches for c in counters)
    del scann.trainer.forward_eval
    spans.close()
    spans.report("phase 8", wall, card)
    from scann_tpu_torch.api import _ladder

    for name, (sp, xyz, lat) in crystals.items():
        status, out = answers.get(name, (None, {}))
        if status != 200:
            failures.append(f"{name}: HTTP {status} {out}")
            continue
        value, ga = out["predictions"][0], np.asarray(out["ga_scores"][0])
        # the reference featurizes exactly what was sent (the CIF text is rounded)
        struct = parse_cif(sent[name]) if name in sent else Structure(sp, xyz, lat)
        _, inputs = scann.featurize_structures([struct])
        with torch.inference_mode():
            p0, g0 = scann_forward(scann.params, scann._to_device(inputs[0]), mp2018)
        ref = p0[0, 0].item() * hyper.target_std + hyper.target_mean
        ref_ga = g0[0, :len(sp), 0].cpu().numpy()
        err_v, err_g = abs(value - ref), float(np.abs(ga - ref_ga).max())
        ok = (np.isfinite(value) and np.isfinite(ga).all() and ga.shape == (len(sp),)
              and err_v <= ATOL + RTOL * abs(ref)
              and np.all(np.abs(ga - ref_ga) <= ATOL + RTOL * np.abs(ref_ga)))
        M, N = inputs[0]["neighbors"].shape[1:]
        rung = (_ladder(M, scann.config.tpu.atoms_pad_multiple),
                _ladder(N, scann.config.tpu.neighbors_pad_multiple))
        batch = [r for r in routes[1:] if r[1:3] == rung]
        print(f"{name} ({'CIF' if name in sent else 'JSON'}, {len(sp)} sites, featurized "
              f"M={M} N={N}, rung {rung}: batches of B={[r[3] for r in batch]} by the "
              f"{batch[-1][0] if batch else None} route): HTTP 200 {value:.6f} eager={ref:.6f} "
              f"|d|={err_v:.2e} "
              f"ga max|d|={err_g:.2e} latency {latencies[name]:.1f} ms", flush=True)
        if not ok:
            failures.append(f"{name}: served answer differs from the eager model "
                            f"({err_v:.3e}, {err_g:.3e})")
    taken = {r: [(M, N, B) for q, M, N, B in routes if q == r]
             for r in ("fused", "loop", "per_layer")}
    print(f"crystal serving from {run_dir}: {len(answers)} requests, {len(routes)} device "
          f"batches (the warm-up's included) by route, as (M, N, B): {taken}; launches: "
          f"molecule kernel {fused_n}, loop kernel {loop_n}, per-layer kernel {layer_n}; "
          f"{serve_s:.1f} s from predictor start  [{card}]", flush=True)
    if sum(B for _, _, _, B in routes[1:]) != len(crystals):
        failures.append(f"served batches {routes[1:]} do not hold each of the {len(crystals)} "
                        "crystals once")
    L = mp2018.n_attention
    if (loop_n == 0 or loop_n != len(taken["loop"]) or fused_n != len(taken["fused"])
            or len(taken["per_layer"]) != 1 or layer_n != L * len(taken["per_layer"])):
        failures.append(f"launches do not match the routes taken: {taken}, molecule {fused_n}, "
                        f"loop {loop_n}, per-layer {layer_n} (L={L})")
    return loop_n, layer_n


def phase9(matrix, mp2018, ptgp, qm9_model, packed_batches, failures, card):
    """The crystal loop-backward kernel against its plain version (the eager
    training forward under torch.autograd, same Philox masks), at 1, 2 and 4
    blocks per structure: a small matrix in cotangent and one-shot mode at
    dropout 0 and 0.1, the atom blocks of 16 and 8, structures with fewer
    atoms than blocks and with unequal shares, then MP2018 (N=32 and N=16)
    and Pt/graphene at full width, with relaunches on garbage-filled scratch
    held bit for bit at every cluster size, and its time. Returns (largest
    abs error, timing of the MP2018 (96, 32) shape)."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(9)
    prng = np.random.default_rng(90)       # the packed batches' draws
    worst = 0.0
    every = kloop.CLUSTER_SIZES[::-1]      # (1, 2, 4)

    def compare(name, cfm, x, mrelu=False, rate=0.0, cotangent=True, relaunches=0,
                clusters=None):
        nonlocal worst
        B, M = x["atom_mask"].shape[:2]
        S = max(kfwd.segment_count(x), 1)
        r = prng if S > 1 else rng
        p = init_params(cfm, torch.Generator().manual_seed(9), "cuda")
        y = torch.from_numpy(r.normal(size=(B, S)).astype(np.float32)).cuda()
        ct = None
        if cotangent:
            ct = (torch.from_numpy(r.normal(size=(B, S)).astype(np.float32)).cuda(),
                  torch.from_numpy(r.normal(size=(B, M, 1)).astype(np.float32)).cuda())
        worst = max(worst, hold_loop_backward(f"phase 9 {name}", cfm, p, x, y, mrelu, rate, 11,
                                              failures, ct, relaunches, clusters))

    cases = list(matrix) + [("scann+ use_drop", dataclasses.replace(matrix[0][1], use_drop=True),
                             False)]
    for name, cfm, mrelu in cases:
        # M=40: an atom block of 32 and one of 8 at one block per structure, shares of 20
        # and 10 atoms at 2 and 4; single-atom structures allowed
        x = synthetic_batch(rng, 6, 40, 8, cfm.use_ring, cfm.feature == "cgcnn", min_atoms=1)
        compare(name, cfm, x, mrelu, 0.0)
        compare(name, cfm, x, mrelu, 0.1, relaunches=2, clusters=every)
    compare("scann+ one atom per chunk", matrix[0][1], synthetic_batch(rng, 4, 72, 24), rate=0.1,
            clusters=every)
    lone = synthetic_batch(rng, 4, 72, 8)
    lone["atom_mask"][0] = 0.0
    lone["atom_mask"][0, 0] = 1.0
    lone["neighbor_mask"][0] = 0.0
    compare("scann+ one-atom structure", matrix[0][1], lone, relaunches=2, clusters=every)
    # M=3 at 4 blocks per structure: the last block has no atom and a row of zeros
    compare("scann+ fewer atoms than blocks", matrix[0][1],
            synthetic_batch(rng, 4, 3, 8, min_atoms=1), rate=0.1, relaunches=2, clusters=every)
    # M=90: shares of 45 + 45 and of 23 + 23 + 23 + 21 atoms, atom blocks of 32 + 13 in a share
    compare("mp2018 full width, unequal shares", mp2018,
            synthetic_batch(rng, 4, 90, 32, n_atoms=mp2018.n_atoms, min_atoms=40),
            rate=0.1, cotangent=False, relaunches=4, clusters=every)
    for M in (160, 208, 226):   # atom blocks of 16 and of 8, the last M the gate takes
        compare("mp2018 full width", mp2018,
                synthetic_batch(rng, 4, M, 32, n_atoms=mp2018.n_atoms, min_atoms=100),
                rate=0.1, cotangent=False, relaunches=12, clusters=every)
    # mostly padding: structures of 3 atoms up in the block-16 and block-8 buckets
    for M in (160, 208):
        compare("mp2018 full width, ragged", mp2018,
                synthetic_batch(rng, 4, M, 32, n_atoms=mp2018.n_atoms), rate=0.1,
                cotangent=False, relaunches=12, clusters=every)
    mp_inputs = synthetic_batch(rng, 64, 96, 32, n_atoms=mp2018.n_atoms, min_atoms=20)
    compare("mp2018 full width", mp2018, mp_inputs, rate=0.1, relaunches=4, clusters=(1, 2))
    # N=16: two atoms per chunk of rows, the shape of phase 10's one-bucket run
    mp16_inputs = synthetic_batch(rng, 64, 96, 16, n_atoms=mp2018.n_atoms, min_atoms=20)
    compare("mp2018 full width", mp2018, mp16_inputs, rate=0.1, relaunches=4, clusters=(1, 2))
    ptgp_inputs = synthetic_batch(rng, 64, 128, 32, use_ring=True, n_atoms=ptgp.n_atoms,
                                  min_atoms=20)
    compare("ptgp full width", ptgp, ptgp_inputs, rate=0.1, relaunches=4, clusters=(1, 2))
    # packed slots: the small matrix in slots of 16 rows; the flagship QM9 packing
    # (capacity 48, whose step this kernel takes) and MP2018-like crystals at capacity
    # 96, up to 8 segments a slot, at 1, 2 and 4 blocks per structure
    for name, cfm, mrelu in matrix:
        compare(name, cfm, pack_batch(synthetic_batch(prng, 12, 8, 8, cfm.use_ring,
                                                      cfm.feature == "cgcnn"), 16),
                mrelu, 0.1, relaunches=2, clusters=every)
    compare("qm9 full width capacity 48", qm9_model, packed_batches["qm9"], rate=0.1,
            relaunches=4, clusters=every)
    compare("mp2018 full width capacity 96", mp2018, packed_batches["mp2018"], rate=0.1,
            relaunches=4, clusters=every)

    timing = None
    packed_timing = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, cfm, x in (("mp2018", mp2018, mp_inputs), ("ptgp", ptgp, ptgp_inputs),
                         ("mp2018", mp2018, mp16_inputs),
                         ("qm9 capacity 48", qm9_model, packed_batches["qm9"]),
                         ("mp2018 capacity 96", mp2018, packed_batches["mp2018"])):
        params = init_params(cfm, torch.Generator().manual_seed(0), "cuda")
        packed = kfwd.pack_params(params, cfm)
        B, M = x["atom_mask"].shape[:2]
        N = x["neighbors"].shape[2]
        S = max(kfwd.segment_count(x), 1)
        C = kloop.cluster_size(B)
        y = torch.from_numpy(np.random.default_rng(1).normal(size=(B, S)).astype(np.float32)
                             ).cuda()
        kloop.check_backward_supported(cfm, M, N)
        kfwd._check_inputs(x, cfm, packed["wde"].device)
        scratch = kloop.loop_backward_scratch(packed, cfm, B, M, N)
        ms, plain_ms = in_turns_ms(
            lambda: kloop.reference_loop_train_grads(params, x, y, cfm, False, 0.1, 7),
            lambda: kloop._launch_backward(packed, x, cfm, y, None, True, False, 0.1, 7, 0,
                                           scratch))
        flops = kloop.loop_backward_flops(cfm, B, M, N)
        recompute = kloop.loop_recompute_flops(cfm, B, M, N)
        _, P = kbwd.grad_layout(packed)
        nbytes = tensor_bytes(x.values(), packed.values()) + 4 * B * S + 4 * (P + B * S)
        bound, by, measured = bound_ms(flops, nbytes, kbwd.backward_fp32_flops(cfm, B, M, N))
        scratch_bytes = tensor_bytes(scratch.values())
        print(f"scann_loop_backward at {name} B={B} M={M} N={N}{packed_label(x)} "
              f"L={cfm.n_attention} (dropout "
              f"0.1, one-shot, with its row reduction; timed in turns: plain, kernel, kernel, "
              f"plain): kernel {ms:.4f} ms on {B} clusters of {C} blocks on {sms} SMs "
              f"({kloop.max_active_clusters(cfm, B, M, N, C)} such clusters run at once), plain "
              f"{plain_ms:.4f} ms, {flops:.4e} FLOP, {nbytes} bytes, bound {bound:.4f} ms by {by} "
              f"({100 * bound / ms:.1f}% of it reached); the schedule adds {recompute:.4e} FLOP "
              f"of recompute, which the bound does not count; scratch "
              f"{scratch_bytes / 2 ** 20:.0f} MiB  [{card}]", flush=True)
        del scratch
        if S > 1:
            packed_timing[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                                   "bound_by": by, "measured_bound_ms": measured, "flops": flops}
        elif timing is None:
            timing = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                      "measured_bound_ms": measured, "flops": flops,
                      "recompute_flops": recompute, "cluster": C}
            # what the cluster gives: the same batch at one block per structure, and the
            # batch doubled (one block per structure: 128 blocks either way)
            one = kloop.loop_backward_scratch(packed, cfm, B, M, N, 1)
            ms1 = cuda_ms(lambda: kloop._launch_backward(packed, x, cfm, y, None, True, False,
                                                         0.1, 7, 0, one, 1), reps=10)
            del one
            twice = {k: torch.cat([v, v]) for k, v in x.items()}
            y2 = torch.cat([y, y])
            C2 = kloop.cluster_size(2 * B)
            two = kloop.loop_backward_scratch(packed, cfm, 2 * B, M, N)
            ms2 = cuda_ms(lambda: kloop._launch_backward(packed, twice, cfm, y2, None, True,
                                                         False, 0.1, 7, 0, two), reps=10)
            del two, twice
            timing["ms_one_block"], timing["ms_batch_doubled"] = ms1, ms2
            print(f"scann_loop_backward at {name} B={B}: {ms1:.4f} ms at one block per "
                  f"structure ({ms1 / ms:.2f}x the time of {C}); with the batch doubled to "
                  f"B={2 * B} ({C2} block per structure) {ms2:.4f} ms, {ms2 / ms:.2f}x the time "
                  f"of B={B} for twice the work  [{card}]", flush=True)
    at_once = {c: kloop.max_active_clusters(mp2018, 64, 96, 32, c) for c in every}
    print(f"scann_loop_backward clusters that run at once at the MP2018 shape, by blocks per "
          f"structure: {at_once} (the wrapper's rule counts on {kloop.CLUSTERS_AT_ONCE}; fewer "
          f"would cost a second wave, not the result)", flush=True)
    print(f"phase 9: worst loop-backward abs error (pred and gradients) {worst:.3e}  [{card}]",
          flush=True)
    timing["packed"] = packed_timing
    return worst, timing


def phase10(mp2018, failures, card):
    """The crystal training path: 2 epochs through Scann.prepare_dataset ->
    train -> evaluate on synthetic periodic crystals of 20-90 sites at the
    full width and depth of the MP2018 model, batch 64, the recipe's 4
    buckets; the same run with the plain step; load_model_infer; and one
    training step by the per-layer route on structures beyond the loop
    backward's gate. Returns (the loop-backward launches of the main path,
    its run directory)."""
    import tempfile

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.data.synthetic import make_synthetic_dataset
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.train.loop import Trainer, _to_device

    class PlainTrainer(Trainer):
        """The same Trainer with the plain version of every backward."""

        def raw_grads(self, batch, y, seed):
            pred, raw = kloop.reference_loop_train_grads(
                self.params, batch, y, self.config.model, self.mrelu_head,
                self.dropout_rate, seed)
            return pred[:, 0], raw

    work = tempfile.mkdtemp(prefix="scann_chip_smoke_crystals_")
    n_crystals = 480       # host Voronoi of periodic cells: 0.065-0.085 s a crystal
    t0 = time.time()
    energy, nbr = make_synthetic_dataset(work, "mplike", n_structures=n_crystals, min_atoms=20,
                                         max_atoms=90, periodic=True, seed=0,
                                         target_names=("formation_energy_per_atom",))
    print(f"phase 10: {n_crystals} synthetic periodic crystals (20-90 sites of Si, O, Al, Fe, "
          f"Mg) written and featurized on the host in {time.time() - t0:.1f} s", flush=True)

    bs = 64

    def config(name, max_buckets, neighbors_multiple):
        return ScannConfig(model=mp2018,
                           hyper=HyperConfig(batch_size=bs, scheduler="sgdr", lr=5e-4,
                                             min_lr=1e-4, target="formation_energy_per_atom",
                                             data_energy_path=energy, data_nei_path=nbr,
                                             epochs=2, seed=0,
                                             save_path=os.path.join(work, name)),
                           tpu=TpuConfig(max_buckets=max_buckets,
                                         neighbors_pad_multiple=neighbors_multiple))

    def hold_first_batches(label, trainer, buckets):
        """The loop-backward kernel against its plain version on the first
        batch that training takes from each bucket: its rows, its dropout
        seed, the trainer's parameters."""
        for bi, b in enumerate(buckets):
            if trainer.train_route(*b.shape) != "loop":
                continue
            idx, seeds = trainer.epoch_plan(0, bi, b.num_structures, bs)
            x = _to_device(b.inputs, trainer.device)
            x = {k: v[idx[0].to(trainer.device)] for k, v in x.items()}
            y = torch.as_tensor(np.asarray(b.targets, np.float32))[idx[0]].to(trainer.device)
            hold_loop_backward(f"phase 10 {label}, bucket {bi}'s first batch", mp2018,
                               trainer.params, x, y, trainer.mrelu_head, trainer.dropout_rate,
                               seeds[0], failures, relaunches=2)

    # ---- the main path: the MP2018 recipe's buckets (max_buckets: 4). The
    # jittered-grid crystals have at most 16 Voronoi neighbours, MP2018's have
    # up to 32: the neighbour axis is padded to the recipe's width, so the
    # largest bucket is the recipe's (96, 32)
    cfg = config("run", 4, 32)
    scann = Scann(cfg, device="cuda")
    scann.prepare_dataset()
    buckets = scann.train_buckets
    trainer = scann.trainer
    batches = lambda bb: sum(-(-b.num_structures // bs) for b in bb)
    train_routes = [trainer.train_route(*b.shape) for b in buckets]
    steps = {r: 2 * batches([b for b, q in zip(buckets, train_routes) if q == r])
             for r in ("fused", "loop", "per_layer")}
    eval_batches = {r: 0 for r in ("fused", "loop", "per_layer")}
    for times, bb in ((2, scann.valid_buckets), (1, scann.test_buckets)):
        for b in bb:
            eval_batches[trainer.eval_route(*b.shape)] += times * batches([b])
    scann.init_params(cfg.hyper.seed)              # what fit() would draw
    hold_first_batches("main path", trainer, buckets)
    passes = trace_passes(trainer, buckets)
    step_ms = []
    train_step = trainer.train_step

    def timed_step(*args):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = train_step(*args)
        e.record()
        step_ms.append((s, e))
        return out

    trainer.train_step = timed_step
    counters = (kbwd.launch_scann_backward, kloop.launch_loop_backward,
                kfwd.fused_scann_forward, kloop.launch_loop_forward, kla.fused_local_attention)
    for c in counters:
        c.launches = 0                               # counts of the training path only
    t1 = time.time()
    hist = scann.train()
    final = bucket_losses(trainer, buckets)        # before evaluate() restores "best"
    result = scann.evaluate()
    torch.cuda.synchronize()
    fused_bwd, loop_bwd, fused_fwd, loop_fwd, layer_fwd = (c.launches for c in counters)
    del trainer.train_step, trainer.epoch_plan
    med = statistics.median(s.elapsed_time(e) for s, e in step_ms)
    n_train = sum(b.num_structures for b in buckets)
    shapes = [(b.shape, b.num_structures, r) for b, r in zip(buckets, train_routes)]
    print(f"phase 10: buckets {shapes}, {len(step_ms)} steps in {time.time() - t1:.1f} s, losses {hist['loss']}, val_mae "
          f"{hist['val_mae']}, test {result}", flush=True)
    print(f"phase 10: median train step {med:.4f} ms (CUDA events), epoch 2 "
          f"{n_train / hist['epoch_time'][1]:.1f} structures/s (the per-pass probes included); "
          f"loop-backward launches {loop_bwd} for {steps['loop']} steps, molecule-backward "
          f"launches {fused_bwd} for {steps['fused']}; eval launches: molecule {fused_fwd}, "
          f"loop {loop_fwd}, per-layer {layer_fwd} for eval batches {eval_batches}  [{card}]",
          flush=True)
    if not all(np.isfinite(hist["loss"])):
        failures.append(f"crystal training loss not finite: {hist['loss']}")
    # A pass over one of four buckets is two steps, and they ride on the Adam
    # momentum of the other buckets' steps, so a pass need not lower its own
    # bucket's loss here (the plain step's run below does the same); the
    # one-bucket run further down is the one held to a falling loss.
    check_passes("kernel", passes, final, None, "phase 10")
    if (loop_bwd == 0 or loop_bwd != steps["loop"] or fused_bwd != steps["fused"]
            or steps["per_layer"] or len(step_ms) != sum(steps.values())):
        failures.append(f"backward launches do not match the routes: loop {loop_bwd}, molecule "
                        f"{fused_bwd} for steps {steps}")
    if not any(b.shape == (96, 32) and r == "loop" for b, r in zip(buckets, train_routes)):
        failures.append(f"the recipe's bucket (96, 32) was not trained by the loop backward: "
                        f"{[b.shape for b in buckets]}")
    if (fused_fwd != eval_batches["fused"] or loop_fwd != eval_batches["loop"]
            or layer_fwd != mp2018.n_attention * eval_batches["per_layer"]):
        failures.append(f"eval launches (molecule {fused_fwd}, loop {loop_fwd}, per-layer "
                        f"{layer_fwd}) do not match the eval batches {eval_batches}")

    # ---- the same run with the plain step: the same losses -------------------
    plain = PlainTrainer(cfg, "cuda", os.path.join(work, "plain"))
    plain.init_state(cfg.hyper.seed)
    plain_passes = trace_passes(plain, buckets)
    plain_hist = plain.fit(buckets, scann.valid_buckets, log_fn=lambda *_: None)
    plain_final = bucket_losses(plain, buckets)
    check_passes("plain", plain_passes, plain_final, None, "phase 10")
    mine = hist["loss"] + [x for p in passes for x in p[2]] + final
    ref = plain_hist["loss"] + [x for p in plain_passes for x in p[2]] + plain_final
    rel = max(abs(a - b) / abs(b) for a, b in zip(mine, ref))
    print(f"phase 10: the plain step's run: losses {plain_hist['loss']}; its epoch and "
          f"per-pass losses against the kernel's: max rel {rel:.3e} (limit {TRAIN_RTOL})",
          flush=True)
    if len(mine) != len(ref) or not rel <= TRAIN_RTOL:
        failures.append(f"kernel and plain two-epoch crystal runs differ: {rel:.3e}")
    del plain

    # a model loaded back from the run directory predicts what the trainer does
    p_trained = scann.predict_data(scann.test_buckets)
    loaded = Scann.load_model_infer(trainer.workdir, device="cuda")
    p_loaded = loaded.predict_data(scann.test_buckets)
    d = float(np.abs(p_trained - p_loaded).max())
    print(f"phase 10: load_model_infer predicts {len(p_loaded)} test crystals, max |d| {d:.3e} "
          f"from the trainer's predictions", flush=True)
    if not (np.isfinite(p_loaded).all() and d <= ATOL + RTOL * np.abs(p_trained).max()):
        failures.append(f"load_model_infer crystal predictions differ by {d:.3e}")
    del loaded

    # ---- one bucket: every pass (an epoch of 6 steps) lowers the loss ----------
    one = Scann(config("one", 1, 8), device="cuda")
    one.prepare_dataset()
    one.init_params(0)
    hold_first_batches("one bucket", one.trainer, one.train_buckets)
    one_passes = trace_passes(one.trainer, one.train_buckets)
    kloop.launch_loop_backward.launches = 0
    one_hist = one.train()
    one_final = bucket_losses(one.trainer, one.train_buckets)
    one_steps = 2 * batches(one.train_buckets)
    del one.trainer.epoch_plan
    check_passes("one bucket", one_passes, one_final, failures, "phase 10")
    n_one = sum(b.num_structures for b in one.train_buckets)
    print(f"phase 10 one bucket {[b.shape for b in one.train_buckets]}: epoch losses "
          f"{one_hist['loss']}, {kloop.launch_loop_backward.launches} loop-backward launches "
          f"for {one_steps} steps, epoch 2 {n_one / one_hist['epoch_time'][1]:.1f} structures/s"
          f"  [{card}]", flush=True)
    if not (all(np.isfinite(one_hist["loss"])) and one_hist["loss"][-1] < one_hist["loss"][0]
            and kloop.launch_loop_backward.launches == one_steps):
        failures.append(f"one-bucket crystal training: epoch losses {one_hist['loss']} not "
                        f"finite and falling, or {kloop.launch_loop_backward.launches} launches "
                        f"for {one_steps} steps")
    del one

    # ---- the third route: one step on structures beyond the backward's gate --
    rng = np.random.default_rng(10)
    M, N, B = 240, 32, 8
    x = synthetic_batch(rng, B, M, N, n_atoms=mp2018.n_atoms, min_atoms=150)
    y = torch.from_numpy(rng.normal(size=B).astype(np.float32)).cuda()
    outcome = []
    for cls in (Trainer, PlainTrainer):
        t = cls(cfg, "cuda", os.path.join(work, "third_" + cls.__name__))
        t.init_state(5)
        route = t.train_route(M, N)
        _, raw = t.raw_grads(x, y, 3)
        before = kla.fused_local_attention.launches, kloop.launch_loop_backward.launches
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        loss, _ = t.train_step(x, y, 5e-4, 3)
        e.record()
        e.synchronize()
        outcome.append((float(loss), raw, s.elapsed_time(e),
                        kla.fused_local_attention.launches - before[0],
                        kloop.launch_loop_backward.launches - before[1]))
    (loss_k, raw_k, ms_k, layer_n, loop_n), (loss_p, raw_p, ms_p, _, _) = outcome
    g_rel, g_key, _ = grad_errors(raw_k, raw_p)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"phase 10: one {route} training step at B={B} M={M} N={N} (beyond the loop "
          f"backward's gate): loss {loss_k:.6f} vs plain step {loss_p:.6f} (rel {rel:.3e}, "
          f"limit {LOSS_RTOL}), gradients worst {g_rel:.2e} of max|plain| at {g_key}, {layer_n} "
          f"per-layer kernel launches, {loop_n} loop-backward launches, {ms_k:.1f} ms (plain "
          f"step {ms_p:.1f} ms)  [{card}]", flush=True)
    if (route != "per_layer" or layer_n != mp2018.n_attention or loop_n != 0
            or not rel <= LOSS_RTOL or not g_rel <= GRAD_RTOL):
        failures.append(f"per-layer training step: route {route}, {layer_n} layer launches, "
                        f"{loop_n} loop-backward launches, loss rel {rel:.3e}, gradients "
                        f"{g_rel:.3e} at {g_key}")
    trace_steps(cfg, buckets[-1], os.path.join(work, "trace"), failures, card)
    return loop_bwd, trainer.workdir, {"data": (energy, nbr), "work": work, "step_ms": med,
                                       "structures_s": n_train / hist["epoch_time"][1],
                                       "name": "phase 10"}


def trace_steps(cfg, bucket, logdir, failures, card):
    """Two training steps of a fresh Trainer on the first batch of
    ``bucket`` under ``utils.trace`` (``torch.profiler``, CPU and CUDA
    activities, as ``cli/train.py --profile`` runs it): the Chrome trace must
    be written. Prints its count of CUDA kernel events and the device ops
    with the most time; a trace without device events is printed as such
    (the profiler's CUDA activity needs CUPTI access to the card)."""
    import glob

    from scann_tpu_torch.train.loop import Trainer, _to_device
    from scann_tpu_torch.utils import trace

    trainer = Trainer(cfg, "cuda", os.path.join(logdir, "run"))
    trainer.init_state(0)
    idx, seeds = trainer.epoch_plan(0, 0, bucket.num_structures, cfg.hyper.batch_size)
    x = {k: v[idx[0].to(trainer.device)] for k, v in _to_device(bucket.inputs,
                                                                 trainer.device).items()}
    y = torch.as_tensor(np.asarray(bucket.targets, np.float32))[idx[0]].to(trainer.device)
    trainer.train_step(x, y, 5e-4, int(seeds[0]))            # outside the trace: warm
    torch.cuda.synchronize()
    t0 = time.time()
    with trace(logdir, python_tracer=False):
        for step in range(2):
            trainer.train_step(x, y, 5e-4, int(seeds[0]) + step)
        torch.cuda.synchronize()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    if not files:
        failures.append(f"trace: no Chrome trace written under {logdir}")
        return
    with open(files[0]) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"trace: 2 training steps at {bucket.shape} (route {trainer.train_route(*bucket.shape)})"
          f" under utils.trace in {time.time() - t0:.1f} s: {os.path.basename(files[0])}, "
          f"{os.path.getsize(files[0])} bytes, {len(events)} events, {len(kernels)} CUDA kernel "
          f"events  [{card}]", flush=True)
    if kernels:
        print("trace: device ops by time: " + "; ".join(
            f"{name[:60]} {us / 1e3:.3f} ms" for name, us in top), flush=True)
    else:
        print("trace: the trace holds no device events (torch.profiler's CUDA activity did not "
              "reach the card here); host events only", flush=True)


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
    _build.build_all(_build.SOURCES + _build.PROBES, force=True)
    print(f"built {list(_build.SOURCES + _build.PROBES)} with nvcc in {time.time() - t0:.1f} s "
          "(one nvcc per source, in parallel)", flush=True)
    for name in ("scann_backward", "scann_loop_backward"):
        for entry, regs, stores, loads in _build.kernel_resources(name):
            if "reduce_rows" not in entry and "selftest" not in entry:
                print(f"{name}.cu: {regs} registers a thread, {stores} bytes of spill stores, "
                      f"{loads} bytes of spill loads (ptxas -v)", flush=True)

    failures = []
    max_err = 0.0
    qm9_model = ModelConfig(n_atoms=10, embedding_dim=48, n_attention=7, local_dim=128,
                            num_head=8, global_dim=128, dense_out=128, scale=0.5,
                            use_attn_norm=True, use_ga_norm=True, use_ring=False,
                            g_update=True, gaussian_d=4.0)

    # ---- phases 11 and 12 (run first): the card's rates, the featurizers ----
    phase_rates(qm9_model, failures, card)
    phase_featurizers(failures, card)

    # ---- phase 1: kernel vs plain version on the card ---------------------
    def compare(name, cfm, inputs, mrelu=False, seed=0):
        nonlocal max_err
        params = init_params(cfm, torch.Generator().manual_seed(seed), "cuda")
        with torch.inference_mode():
            pred, ga = kfwd.fused_scann_forward(params, inputs, cfm, mrelu)
            torch.cuda.synchronize()
            pred0, ga0 = kfwd.reference_scann_forward(params, inputs, cfm, mrelu)
        line = [name, f"B={inputs['atomic'].shape[0]} M={inputs['atomic'].shape[1]} "
                      f"N={inputs['neighbors'].shape[2]}{packed_label(inputs)}"]
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
    qm9_inputs = synthetic_batch(rng, 128, 32, 16)
    compare("qm9 full width", qm9_model, qm9_inputs)
    compare("qm9 single atoms", qm9_model, synthetic_batch(rng, 16, 8, 8, min_atoms=1))
    lone = synthetic_batch(rng, 4, 8, 8)
    lone["atom_mask"][0] = 0.0
    lone["atom_mask"][0, 0] = 1.0
    lone["neighbor_mask"][0] = 0.0
    compare("qm9 one-atom molecule", qm9_model, lone)
    compare("qm9 widest rung M=64", qm9_model, synthetic_batch(rng, 32, 64, 16))
    # packed slots (structure packing): the small matrix in slots of 16 rows, and
    # molecules of 3-29 atoms at the flagship's packing capacity 48 and the derived 32,
    # up to 8 segments a slot
    for name, cfm, mrelu in matrix:
        compare(f"{name} packed", cfm,
                pack_batch(synthetic_batch(rng, 12, 8, 8, cfm.use_ring, cfm.feature == "cgcnn"),
                           16), mrelu)
    qm9_mols = synthetic_batch(rng, 256, 29, 16)
    packed_qm9 = {cap: pack_batch(qm9_mols, cap) for cap in (48, 32)}
    for cap, xp in packed_qm9.items():
        compare(f"qm9 full width capacity {cap}", qm9_model, xp)

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
    spans = ServingSpans(scann)
    server = PredictionServer(predictor, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://{server.host}:{server.port}"
    answers, latencies, sent, wall = {}, {}, {}, {}

    def post(name, body, ctype):
        t = time.perf_counter()
        req = urllib.request.Request(base + "/predict", data=body,
                                     headers={"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                answers[name] = (r.status, json.loads(r.read()))
        except Exception as e:  # recorded, then reported as a failure below
            answers[name] = (getattr(e, "code", None), {"error": repr(e)})
        wall[name] = (len(mols[name][0]), t, time.perf_counter())
        latencies[name] = 1e3 * (wall[name][2] - t)

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
    spans.close()
    spans.report("phase 2", wall, card)

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
    fwd_bound, fwd_by, fwd_measured = bound_ms(flops, nbytes,
                                               kfwd.forward_fp32_flops(qm9_model, B, M, N))
    print(f"scann_forward at B={B} M={M} N={N}: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, {flops:.4e} FLOP, {nbytes} bytes, bound "
          f"{fwd_bound:.4f} ms by {fwd_by} ({100 * fwd_bound / kernel_ms:.1f}% of it reached)  "
          f"[{card}]", flush=True)
    bwd_time = time_backward(qm9_model, params, packed, qm9_inputs, card)
    # the segmented kernels at the packed shapes: #1 at capacity 48, #2 at 32
    xp = packed_qm9[48]
    with torch.inference_mode():
        kfwd._check_inputs(xp, qm9_model, packed["wde"].device)
        p_ms, p_plain_ms = in_turns_ms(lambda: kfwd.reference_scann_forward(params, xp, qm9_model),
                                       lambda: kfwd._launch(packed, xp, qm9_model, False), 2, 5)
    B, M = xp["atomic"].shape
    N = xp["neighbors"].shape[2]
    p_flops = kfwd.forward_flops(qm9_model, B, M, N)
    p_bound, p_by, p_measured = bound_ms(p_flops, tensor_bytes(xp.values(), packed.values())
                                         + 4 * (B * xp["segment_onehot"].shape[-1] + B * M),
                                         kfwd.forward_fp32_flops(qm9_model, B, M, N))
    print(f"scann_forward at B={B} M={M} N={N}{packed_label(xp)} (timed in turns: plain, "
          f"kernel, kernel, plain): kernel {p_ms:.4f} ms, plain {p_plain_ms:.4f} ms, "
          f"{p_flops:.4e} FLOP, bound {p_bound:.4f} ms by {p_by} "
          f"({100 * p_bound / p_ms:.1f}% of it reached)  [{card}]", flush=True)
    fwd_packed_time = {"ms": p_ms, "plain_ms": p_plain_ms, "bound_ms": p_bound,
                       "bound_by": p_by, "measured_bound_ms": p_measured, "flops": p_flops}
    bwd_packed_time = time_backward(qm9_model, params, packed, packed_qm9[32], card)

    # ---- phase 4: the backward kernel against its plain version -------------
    check_products(failures, card)
    bwd_err = phase4(matrix, qm9_model, qm9_inputs, packed_qm9, failures, card)

    # ---- phase 5: the training path, then with structure packing --------------
    train_launches, qm9_run = phase5(qm9_model, failures, card)
    packed_launches = train_packed("phase 5 packed capacity 48", qm9_model, qm9_run, 48, 3, 128,
                                   ("fused", "loop"), failures, card, compare_unpacked=True)
    derived = train_packed("phase 5 packed derived capacity", qm9_model, qm9_run, None, 1, 128,
                           ("fused", "fused"), failures, card)
    packed_launches = {k: v + derived[k] for k, v in packed_launches.items()}

    # ---- phases 6-8: crystals ---------------------------------------------------
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_loop as kloop

    mp2018, ptgp = crystal_models()
    mp_packed = pack_batch(synthetic_batch(np.random.default_rng(66), 64, 90, 32,
                                           n_atoms=mp2018.n_atoms, min_atoms=20), 96)
    loop_err, loop_time = phase6(matrix, mp2018, ptgp, mp_packed, failures, card)
    layer_err, layer_time = phase7(mp2018, failures, card)

    # ---- phases 9-10: crystal training, then phase 8 serves what phase 10 trained --
    loop_bwd_err, loop_bwd_time = phase9(matrix, mp2018, ptgp, qm9_model,
                                         {"qm9": packed_qm9[48], "mp2018": mp_packed}, failures,
                                         card)
    loop_bwd_launches, run_dir, crystal_run = phase10(mp2018, failures, card)
    crystal_packed = train_packed("phase 10 packed capacity 96", mp2018, crystal_run, 96, 1, 64,
                                  ("loop", "loop"), failures, card, neighbors_multiple=32,
                                  compare_unpacked=True)
    packed_launches = {k: v + crystal_packed[k] for k, v in packed_launches.items()}
    loop_launches, layer_launches = phase8(mp2018, run_dir, failures, card)

    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), flush=True)
        return 1
    from scann_tpu_torch.kernels import scann_backward as kbwd

    # "packed_launches": the packed training paths' launches (phase 5 packed at
    # capacities 48 and 32, phase 10 packed at 96); "packed": the segmented
    # kernel timed at a packed shape
    kernels = [{
        "name": "scann_forward", "route": "cuda", "source": kfwd.SOURCE,
        "replaces": kfwd.REPLACES, "launches": launches,
        "max_abs_err": max(max_err, bwd_err["forward_dropout"]), "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": fwd_bound, "bound_by": fwd_by,
        "measured_bound_ms": fwd_measured, "library_ms": None, "flops": flops,
        "packed_launches": packed_launches["scann_forward"], "packed": fwd_packed_time,
    }, {
        "name": "scann_backward", "route": "cuda", "source": kbwd.SOURCE,
        "replaces": kbwd.REPLACES, "launches": train_launches,
        "max_abs_err": bwd_err["backward"], "ms": bwd_time["ms"],
        "plain_ms": bwd_time["plain_ms"], "bound_ms": bwd_time["bound_ms"],
        "bound_by": bwd_time["bound_by"], "measured_bound_ms": bwd_time["measured_bound_ms"],
        "library_ms": None, "flops": bwd_time["flops"],
        "recompute_flops": bwd_time["recompute_flops"],
        "packed_launches": packed_launches["scann_backward"],
        "packed": {k: bwd_packed_time[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "measured_bound_ms", "flops")},
    }, {
        "name": "scann_loop", "route": "cuda", "source": kloop.SOURCE,
        "replaces": kloop.REPLACES, "launches": loop_launches, "max_abs_err": loop_err,
        "library_ms": None, "packed_launches": packed_launches["scann_loop"], **loop_time,
    }, {
        "name": "scann_loop_backward", "route": "cuda", "source": kloop.BACKWARD_SOURCE,
        "replaces": kloop.BACKWARD_REPLACES, "launches": loop_bwd_launches,
        "max_abs_err": loop_bwd_err, "library_ms": None,
        "packed_launches": packed_launches["scann_loop_backward"], **loop_bwd_time,
    }, {
        "name": "local_attention", "route": "cuda", "source": kla.SOURCE,
        "replaces": kla.REPLACES, "launches": layer_launches, "max_abs_err": layer_err,
        "library_ms": None, **layer_time,
    }]
    for k in kernels:
        print(f"{k['name']}: {k['ms']:.4f} ms, {100 * k['bound_ms'] / k['ms']:.1f}% of its bound "
              f"at the published rates ({k['bound_ms']:.4f} ms), "
              f"{100 * k['measured_bound_ms'] / k['ms']:.1f}% of it at the measured rates "
              f"({k['measured_bound_ms']:.4f} ms)  [{card}]", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
