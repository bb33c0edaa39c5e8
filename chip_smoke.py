"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``scann_tpu_torch/csrc`` (one
nvcc per source, all at once) and, at the full width of the flagship QM9
SCANN+ model (``configs/model_qm9.yaml``: 7 layers, D=128, 8 heads,
embedding 48; random weights from a seed):

1. holds the forward kernel against its plain PyTorch version;
2. serves a few molecules over HTTP through ``PredictionServer`` (the
   serving path) and checks every answer against the eager model;
3. times both kernels at the QM9 batch shape against their bounds and
   their plain versions;
4. holds the backward kernel (at dropout 0 and 0.1, one-shot and with a
   GA cotangent) and the forward kernel with dropout against their plain
   versions on the same Philox masks;
5. trains 2 epochs through ``Scann.prepare_dataset -> train -> evaluate``
   (the training path) on ~1000 synthetic QM9-like molecules in the
   flagship recipe's two buckets; checks the launches, that each pass over
   a bucket lowers that bucket's loss without dropout, that the same run
   with the plain step gives the same losses, 3 kernel steps against 3
   plain steps and ``load_model_infer``; then trains 2 epochs in one
   bucket and checks that the epoch loss and the training-set loss fall.

Prints the card (``nvidia-smi``), the build time, each comparison and
phase, then one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Exits non-zero on any failure, and
without printing a result when CUDA is not available.

Tolerances. Forward: rtol 1e-4, atol 1e-5 on pred and GA scores: the
kernel sums its FP32 products in another order than cuBLAS (TF32 off) and
carries the difference through 7 LayerNormed layers. Backward: pred as the
forward; each gradient within 1e-4 x its max |plain|, since FP32 sums over
up to 65,536 rows run in another order. Training: 3-step losses to 1e-4
relative; the two-epoch runs' losses to 1e-3 relative, since Adam carries
the FP32 differences through 16 steps.
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
GRAD_RTOL = 1e-4             # of each gradient's max |plain|
LOSS_RTOL = 1e-4
TRAIN_RTOL = 1e-3            # two epochs, kernel against plain step
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


def time_backward(cfm, params, packed, inputs, card):
    """Phase 3 for the backward kernel: its launch plus the row reduction at
    the QM9 training shape (dropout 0.1, one-shot), against its bound and
    its plain version (the eager training forward under torch.autograd)."""
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd

    B, M = inputs["atomic"].shape
    N = inputs["neighbors"].shape[2]
    y = torch.from_numpy(np.random.default_rng(1).normal(size=B).astype(np.float32)).cuda()
    kfwd._check_inputs(inputs, cfm, packed["wde"].device)
    ms = cuda_ms(lambda: kbwd._launch(packed, inputs, cfm, y, None, True, False, 0.1, 7))
    plain_ms = cuda_ms(lambda: kbwd.reference_fused_scann_train_grads(
        params, inputs, y, cfm, False, 0.1, 7), reps=10)
    flops = kbwd.backward_flops(cfm, B, M, N)
    recompute = kbwd.recompute_flops(cfm, B, M, N)
    _, P = kbwd.grad_layout(packed)
    nbytes = (sum(t.numel() * t.element_size() for t in inputs.values())
              + sum(t.numel() * t.element_size() for t in packed.values())
              + 4 * B + 4 * (P + B))          # targets in; gradients and pred out
    ops_ms = 1e3 * flops / H100_FP32_FLOPS
    bytes_ms = 1e3 * nbytes / H100_HBM_BYTES_S
    bound = max(ops_ms, bytes_ms)
    print(f"scann_backward at B={B} M={M} N={N} (dropout 0.1, one-shot, with its row "
          f"reduction): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {flops:.4e} FLOP, "
          f"{nbytes} bytes, bound {bound:.4f} ms ({100 * bound / ms:.1f}% of it reached)  "
          f"[{card}]", flush=True)
    print(f"scann_backward: the kernel's schedule adds {recompute:.4e} FLOP of recompute "
          f"({1e3 * recompute / H100_FP32_FLOPS:.4f} ms at the FP32 peak), which the bound "
          f"does not count", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "flops": flops,
            "recompute_flops": recompute,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def phase4(matrix, qm9_model, qm9_inputs, failures, card):
    """The backward kernel (one-shot and with a GA cotangent) and the
    forward kernel with dropout against their plain versions, on the same
    Philox masks. Returns the largest absolute errors."""
    import dataclasses

    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(4)
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
        y = torch.from_numpy(rng.normal(size=B).astype(np.float32)).cuda()
        ctp = torch.from_numpy(rng.normal(size=(B, 1)).astype(np.float32)).cuda()
        ctg = torch.from_numpy(rng.normal(size=(B, M, 1)).astype(np.float32)).cuda()
        for rate in (0.0, 0.1):
            check_backward(f"{name} dropout {rate}", cfm, p, x, y, ctp, ctg, mrelu, rate,
                           err, failures)
    x = qm9_inputs
    p = init_params(qm9_model, torch.Generator().manual_seed(3), "cuda")
    y = torch.from_numpy(rng.normal(size=x["atomic"].shape[0]).astype(np.float32)).cuda()
    check_backward("qm9 full width dropout 0.1", qm9_model, p, x, y, None, None, False, 0.1,
                   err, failures)
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
        if got_p is not None:
            ab, _, ok = errors(got_p, want_p)
            err["backward"] = max(err["backward"], ab)
            line.append(f"{what} pred {ab:.2e}")
            if not ok:
                failures.append(f"{label} {what} pred: max_abs {ab:.3e}")
        if set(got_g) != set(want_g):
            failures.append(f"{label} {what}: gradient keys differ")
            continue
        rel, key, ab = grad_errors(got_g, want_g)
        err["backward"] = max(err["backward"], ab)
        finite = all(bool(torch.isfinite(v).all()) for v in got_g.values())
        line.append(f"{what} grads worst {rel:.2e} of max|plain| at {key}")
        if rel > GRAD_RTOL or not finite:
            failures.append(f"{label} {what}: gradient {key} off by {rel:.3e} of its max "
                            f"(limit {GRAD_RTOL}), finite={finite}")
    print("  ".join(line), flush=True)


def bucket_losses(trainer, buckets):
    """RMSE + l2 of the trainer's current weights on each bucket, without
    dropout (the forward kernel). The launch counters and the trainer's
    counting wrapper are left as they were."""
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.models.scann import l2_penalty

    saved = kfwd.fused_scann_forward.launches
    wrapper = trainer.__dict__.pop("forward_eval", None)
    l2 = float(l2_penalty(trainer.params, trainer.config.hyper.l2_reg))
    out = []
    for b, dev in zip(buckets, trainer._put_buckets(buckets, "train")):
        _, _, pred, y = trainer._evaluate_buckets([b], [dev])
        out.append(float(np.sqrt(np.mean((pred - y) ** 2))) + l2)
    if wrapper is not None:
        trainer.forward_eval = wrapper
    kfwd.fused_scann_forward.launches = saved
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


def check_passes(label, passes, final, failures):
    """Each pass over a bucket lowers that bucket's loss without dropout;
    prints what every pass did to every bucket."""
    ends = [p[2] for p in passes[1:]] + [final]
    for (epoch, bucket, before), after in zip(passes, ends):
        moves = ", ".join(f"bucket {j} {x:.6f} -> {y:.6f}"
                          for j, (x, y) in enumerate(zip(before, after)))
        print(f"phase 5 {label}: epoch {epoch} pass over bucket {bucket}: {moves}", flush=True)
        if not (np.isfinite(after[bucket]) and after[bucket] < before[bucket]):
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
    return bwd_launches


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
    print(f"built {list(_build.SOURCES)} with nvcc in {time.time() - t0:.1f} s "
          "(one nvcc per source, in parallel)", flush=True)

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
          f"of it reached)  [{card}]", flush=True)
    bwd_time = time_backward(qm9_model, params, packed, qm9_inputs, card)

    # ---- phase 4: the backward kernel against its plain version -------------
    bwd_err = phase4(matrix, qm9_model, qm9_inputs, failures, card)

    # ---- phase 5: the training path ------------------------------------------
    train_launches = phase5(qm9_model, failures, card)

    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), flush=True)
        return 1
    from scann_tpu_torch.kernels import scann_backward as kbwd

    kernels = [{
        "name": "scann_forward", "route": "cuda", "source": kfwd.SOURCE,
        "replaces": kfwd.REPLACES, "launches": launches,
        "max_abs_err": max(max_err, bwd_err["forward_dropout"]), "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None, "flops": flops,
    }, {
        "name": "scann_backward", "route": "cuda", "source": kbwd.SOURCE,
        "replaces": kbwd.REPLACES, "launches": train_launches,
        "max_abs_err": bwd_err["backward"], "ms": bwd_time["ms"],
        "plain_ms": bwd_time["plain_ms"], "bound_ms": bwd_time["bound_ms"],
        "bound_by": bwd_time["bound_by"], "library_ms": None, "flops": bwd_time["flops"],
        "recompute_flops": bwd_time["recompute_flops"],
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
