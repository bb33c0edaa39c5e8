"""Training on one GPU (port of ``scann_tpu/train/loop.py`` for unpacked
buckets).

The reference recipe (``scann_model.py:42-319``): RMSE loss plus the Keras
l2(1e-4) kernel penalties, Adam(b1=0.9, b2=0.999, eps=1e-7) with the
``decay=1e-5`` inverse-time factor, cosine or SGDR, early stopping on val
MAE, best-val checkpoints, a test report.

- Each bucket's padded arrays go to the device once; a step gathers its
  batch there with an index vector (``loop.py:340-360``), and each epoch
  wrap-pads its last batch.
- A step takes one of three routes, chosen from (config, M, N) before
  anything is launched (``Trainer.train_route``, the mirror of
  ``eval_route`` and of ``loop.py:384-430``): "fused", ONE launch of the
  molecule backward kernel (forward recompute, residual and every gradient)
  plus its row reduction where its gate passes (M <= 32 at D = 128); else
  "loop", ONE launch of the crystal loop backward kernel where its gate
  passes (M <= 208 at N = 32, D = 128); else "per_layer", the per-layer
  model under ``torch.autograd`` (one LocalAttention kernel launch per layer
  going forward, the plain layer going back). All run at dropout 0.1 on the
  same Philox masks; the raw gradients are scaled by 1 / (n * rmse) and the
  l2 gradient is added, as at ``loop.py:391-427``. A kernel that fails to
  build or launch raises: no route gives way to another at run time. On the
  CPU the same routes run the kernels' plain versions.
- The epoch order and the dropout seeds come from a ``torch.Generator``
  seeded from (seed, epoch, bucket) alone, so a resumed run replays an
  uninterrupted one exactly (``loop.py:738-751``).
- ``version`` counts parameter changes (``init_state``, ``load_params``,
  every optimizer step, a restore); the kernel layout of the weights
  (``pack_params``) is rebuilt when it moved.
- Checkpoints are ``torch.save`` files of params, Adam state, step, the
  run's meta (SGDR state included) and ``config.to_dict()``, loaded with
  ``weights_only=True``.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from scann_tpu_torch.config import ScannConfig, save_config
from scann_tpu_torch.data.pipeline import PackedBucket
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.kernels.scann_backward import (
    fused_scann_train_grads,
    grads_from_flat,
    launch_scann_backward,
)
from scann_tpu_torch.kernels.scann_forward import (
    dropout_masks_for,
    launch_scann_forward,
    pack_params,
)
from scann_tpu_torch.kernels.scann_loop import (
    launch_loop_backward,
    launch_loop_forward,
    loop_scann_train_grads,
)
from scann_tpu_torch.models.scann import (
    init_params,
    l2_penalty,
    param_shapes,
    regularized_keys,
    scann_forward,
)
from scann_tpu_torch.train.schedules import SGDRSchedule, make_cosine_lr

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-7   # Keras Adam (scann_model.py:212)
TRAIN_DROPOUT = 0.1


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    ss_res = float(np.sum((y_true - y_pred) ** 2))
    ss_tot = float(np.sum((y_true - np.mean(y_true)) ** 2))
    return 1.0 - ss_res / (ss_tot + 1e-12)


def _to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device)
            continue
        dtype = (torch.int32 if k == "neighbors" or (k == "atomic" and v.ndim == 2)
                 else torch.float32)
        out[k] = torch.as_tensor(np.ascontiguousarray(v)).to(device, dtype)
    return out


class Trainer:
    """Parameters, Adam state and the train / eval / predict loops of one
    config on one device."""

    def __init__(self, config: ScannConfig, device="cuda", workdir: Optional[str] = None):
        self.config = config
        self.device = torch.device(device)
        self.mrelu_head = config.hyper.target == "e_b"
        self.workdir = workdir or "{}_{}".format(config.hyper.save_path, config.hyper.target)
        self.dropout_rate = TRAIN_DROPOUT
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}
        self.step = 0
        self.version = 0
        self._packed: Optional[Tuple[int, Dict[str, torch.Tensor]]] = None
        self._device_buckets: Dict[Tuple[str, int], tuple] = {}
        self._loop_scratch: Dict[Tuple[int, int, int], dict] = {}
        self.history: Optional[Dict[str, list]] = None

    # --- parameters and optimizer state ---------------------------------------

    def load_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Take ``params`` (flat dict keyed like ``param_shapes``) with a
        fresh Adam state at step 0."""
        want = param_shapes(self.config.model)
        if set(params) != set(want):
            raise ValueError(f"parameter keys do not match the config: "
                             f"{sorted(set(params) ^ set(want))}")
        self.params = {k: params[k].to(self.device, torch.float32).contiguous() for k in want}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.step = 0
        self.version += 1
        return self.params

    def init_state(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Random parameters with the Keras initializers, from ``seed``."""
        return self.load_params(init_params(self.config.model, torch.Generator().manual_seed(seed)))

    def kernel_params(self) -> Dict[str, torch.Tensor]:
        """The whole-model kernels' layout of the current weights (the
        molecule and the crystal kernel share it), rebuilt when ``version``
        moved since it was built."""
        if self._packed is None or self._packed[0] != self.version:
            self._packed = (self.version, pack_params(self.params, self.config.model))
        return self._packed[1]

    def eval_route(self, M: int, N: int) -> str:
        """Which forward a CUDA batch of shape (M, N) takes, from the
        kernels' gates alone: "fused" (the whole-model molecule kernel),
        "loop" (the whole-model crystal kernel) or "per_layer" (the eager
        model with one LocalAttention kernel launch per layer)."""
        cfm = self.config.model
        if kfwd.refusal(cfm, M, N) is None:
            return "fused"
        if kloop.refusal(cfm, M, N) is None:
            return "loop"
        return "per_layer"

    def forward_eval(self, params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Deterministic forward -> (property [B, 1], ga_score [B, M, 1]).

        On CUDA the route is chosen from (config, M, N) before anything is
        launched (``eval_route``): the whole-model kernel where its gate
        passes, else the crystal loop kernel where its gate passes, else the
        per-layer model. A kernel that fails to build or launch raises;
        nothing falls back. On the CPU it is the eager model."""
        cfm = self.config.model
        with torch.inference_mode():
            if self.device.type != "cuda":
                return scann_forward(params, batch, cfm, self.mrelu_head)
            route = self.eval_route(batch["atomic"].shape[1], batch["neighbors"].shape[2])
            if route == "per_layer":
                return scann_forward(params, batch, cfm, self.mrelu_head, use_pallas=True)
            packed = (self.kernel_params() if params is self.params
                      else pack_params(params, cfm))
            launch = launch_scann_forward if route == "fused" else launch_loop_forward
            return launch(packed, batch, cfm, self.mrelu_head)

    # --- one step ----------------------------------------------------------------

    def train_step(self, batch: Dict[str, torch.Tensor], y: torch.Tensor, lr: float,
                   seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One Adam step on one batch; returns (loss, mae) as device scalars
        (the loss is RMSE + l2, as the JAX step reports it)."""
        l2 = self.config.hyper.l2_reg
        pred, raw = self.raw_grads(batch, y, seed)
        err = pred - y
        rmse = torch.sqrt(torch.mean(err * err))
        mae = torch.mean(torch.abs(err))
        loss = rmse + l2_penalty(self.params, l2)
        keys = list(self.params)
        grads = [raw[k] for k in keys]
        torch._foreach_mul_(grads, 1.0 / (y.shape[0] * rmse))
        reg = regularized_keys(self.params)
        torch._foreach_add_([raw[k] for k in reg], [self.params[k] for k in reg], alpha=2 * l2)
        self._adam(keys, grads, lr)
        return loss.detach(), mae.detach()

    def train_route(self, M: int, N: int) -> str:
        """Which backward a training batch of shape (M, N) takes, from the
        kernels' gates alone: "fused" (the whole-model molecule backward),
        "loop" (the whole-model crystal loop backward) or "per_layer" (the
        per-layer model under ``torch.autograd``)."""
        cfm = self.config.model
        if kbwd.refusal(cfm, M, N) is None:
            return "fused"
        if kloop.backward_refusal(cfm, M, N) is None:
            return "loop"
        return "per_layer"

    def raw_grads(self, batch: Dict[str, torch.Tensor], y: torch.Tensor, seed: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(pred [B], gradients of 0.5 * sum((pred - y)^2)) at the training
        dropout, by the route of ``train_route``: on CUDA one launch of the
        molecule or the loop backward kernel (the loop kernel's scratch is
        kept per batch shape), or the per-layer model under autograd; on the
        CPU the kernels' plain versions."""
        cfm = self.config.model
        B, M = batch["atomic"].shape[:2]
        N = batch["neighbors"].shape[2]
        route = self.train_route(M, N)
        if route == "per_layer":
            return self._per_layer_grads(batch, y, seed)
        if self.device.type == "cuda":
            packed = self.kernel_params()
            if route == "fused":
                flat, pred = launch_scann_backward(packed, batch, cfm, y, None, True,
                                                   self.mrelu_head, self.dropout_rate, seed)
            else:
                scratch = self._loop_scratch.get((B, M, N))
                if scratch is None:
                    scratch = self._loop_scratch[(B, M, N)] = kloop.loop_backward_scratch(
                        packed, cfm, B, M, N)
                flat, pred = launch_loop_backward(packed, batch, cfm, y, None, True,
                                                  self.mrelu_head, self.dropout_rate, seed,
                                                  scratch=scratch)
            return pred, grads_from_flat(flat, packed, cfm)
        grads_fn = fused_scann_train_grads if route == "fused" else loop_scann_train_grads
        pred, raw = grads_fn(self.params, batch, y, cfm, self.mrelu_head, self.dropout_rate, seed)
        return pred[:, 0], raw

    def _per_layer_grads(self, batch: Dict[str, torch.Tensor], y: torch.Tensor, seed: int
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The third route: the training forward of the per-layer model
        (``scann_forward(use_pallas=True)``: on CUDA one LocalAttention
        kernel launch per layer, whose backward recomputes the plain layer)
        differentiated by ``torch.autograd``; the same residual and the same
        dropout masks as the whole-model kernels."""
        cfm = self.config.model
        masks = dropout_masks_for(cfm, batch, self.dropout_rate, seed)
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
            pred, _ = scann_forward(leaves, batch, cfm, self.mrelu_head, masks, use_pallas=True)
            loss = 0.5 * ((pred[:, 0] - y) ** 2).sum()
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return pred.detach()[:, 0], dict(zip(leaves, grads))

    def _adam(self, keys: List[str], grads: List[torch.Tensor], lr: float) -> None:
        """optax.scale_by_adam(0.9, 0.999, eps=1e-7), then params -= lr * update."""
        t = self.step + 1
        mu = [self.mu[k] for k in keys]
        nu = [self.nu[k] for k in keys]
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, grads, alpha=1 - ADAM_B1)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - ADAM_B2)
        denom = torch._foreach_div(nu, 1 - ADAM_B2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        update = torch._foreach_div(mu, 1 - ADAM_B1 ** t)
        torch._foreach_div_(update, denom)
        with torch.no_grad():
            torch._foreach_add_([self.params[k] for k in keys], update, alpha=-lr)
        self.step = t
        self.version += 1

    def epoch_plan(self, epoch: int, bucket: int, n_rows: int, batch_size: int
                   ) -> Tuple[torch.Tensor, List[int]]:
        """The batches of one bucket in one epoch ([steps, batch] row
        indices, the last batch wrap-padded) and each step's dropout seed,
        from (seed, epoch, bucket) alone."""
        state = np.random.SeedSequence([self.config.hyper.seed, epoch, bucket]).generate_state(2)
        g = torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))
        steps = -(-n_rows // batch_size)
        perm = torch.randperm(n_rows, generator=g)
        idx = perm[torch.arange(steps * batch_size) % n_rows].view(steps, batch_size)
        seeds = torch.randint(0, 2 ** 31 - 1, (steps,), generator=g).tolist()
        return idx, seeds

    # --- device-resident data ----------------------------------------------------

    def _put_buckets(self, buckets: List[PackedBucket], tag: str):
        """Bucket arrays on the device, once per (tag, bucket); the entry keeps
        the bucket alive so its id() cannot be reused by another one."""
        live = {(tag, id(b)) for b in buckets}
        for key in [k for k in self._device_buckets if k[0] == tag and k not in live]:
            del self._device_buckets[key]
        out = []
        for b in buckets:
            key = (tag, id(b))
            if key not in self._device_buckets:
                if "segment_mask" in b.inputs:
                    raise NotImplementedError("packed buckets: structure packing is not "
                                              "ported yet")
                self._device_buckets[key] = (
                    b, _to_device(b.inputs, self.device),
                    torch.as_tensor(np.asarray(b.targets, np.float32), device=self.device))
            out.append(self._device_buckets[key][1:])
        return out

    # --- training ------------------------------------------------------------------

    def fit(self, train_buckets: List[PackedBucket], valid_buckets: List[PackedBucket],
            epochs: Optional[int] = None, log_fn=print, resume: bool = False) -> Dict[str, list]:
        """Train; ``resume=True`` continues from the workdir's 'last'
        checkpoint (params, Adam state, step and schedule)."""
        hyper = self.config.hyper
        epochs = epochs or hyper.epochs
        bs = hyper.batch_size
        steps_per_epoch = sum(-(-b.num_structures // bs) for b in train_buckets)
        sgdr = None
        if hyper.scheduler == "sgdr":
            sgdr = SGDRSchedule(lr_max=hyper.lr, lr_min=hyper.min_lr)
        else:
            lr_fn = make_cosine_lr(hyper.lr, hyper.min_lr, steps_per_epoch, epochs,
                                   hyper.adam_decay)
        if self.params is None:
            self.init_state(hyper.seed)
        dev_train = self._put_buckets(train_buckets, "train")
        dev_valid = self._put_buckets(valid_buckets, "valid")

        os.makedirs(self.workdir, exist_ok=True)
        self.config.tpu.observed_buckets = [
            list(s) for s in sorted({b.shape for b in list(train_buckets) + list(valid_buckets)})]
        save_config(self.config, os.path.join(self.workdir, "config.yaml"))

        history = {"loss": [], "mae": [], "val_mae": [], "val_r2": [], "lr": [],
                   "epoch_time": []}
        best_val, best_epoch, start_epoch = math.inf, -1, 0
        metrics_path = os.path.join(self.workdir, "metrics.jsonl")
        if resume and os.path.exists(self._checkpoint_path("last")):
            meta = self.restore_checkpoint("last")
            start_epoch = int(meta.get("epoch", -1)) + 1
            best_val = float(meta.get("best_val", math.inf))
            best_epoch = int(meta.get("best_epoch", -1))
            if sgdr is not None and "sgdr_triggered" in meta:
                sgdr.load_state_dict(meta)
            log_fn(f"resumed from epoch {start_epoch} (best val_mae {best_val:.5f})")

        n_train = sum(b.num_structures for b in train_buckets)
        for epoch in range(start_epoch, epochs):
            t0 = time.perf_counter()
            epoch_lr = sgdr.epoch_begin() if sgdr else 0.0
            bucket_losses, bucket_maes = [], []
            for bi, (binputs, btargets) in enumerate(dev_train):
                idx, seeds = self.epoch_plan(epoch, bi, btargets.shape[0], bs)
                idx = idx.to(self.device)
                losses, maes = [], []
                for k in range(idx.shape[0]):
                    rows = idx[k]
                    batch = {name: v[rows] for name, v in binputs.items()}
                    lr = (epoch_lr / (1.0 + hyper.adam_decay * self.step) if sgdr
                          else lr_fn(self.step))
                    loss, mae = self.train_step(batch, btargets[rows], lr, seeds[k])
                    losses.append(loss)
                    maes.append(mae)
                bucket_losses.append(torch.stack(losses).mean())
                bucket_maes.append(torch.stack(maes).mean())
            # the mean of the buckets' means, as the JAX loop reports it (loop.py:759-760)
            train_loss = float(torch.stack(bucket_losses).mean())
            train_mae = float(torch.stack(bucket_maes).mean())
            val_mae, val_r2, _, _ = self._evaluate_buckets(valid_buckets, dev_valid)
            dt = time.perf_counter() - t0
            lr_now = float(epoch_lr if sgdr else lr_fn(self.step))
            if sgdr:
                sgdr.epoch_end(val_mae)
            for k, v in (("loss", train_loss), ("mae", train_mae), ("val_mae", val_mae),
                         ("val_r2", val_r2), ("lr", lr_now), ("epoch_time", dt)):
                history[k].append(v)
            rec = {"epoch": epoch, "loss": train_loss, "mae": train_mae, "val_mae": val_mae,
                   "val_r2": val_r2, "lr": lr_now, "time_s": round(dt, 3),
                   "structures_per_sec": round(n_train / dt, 1)}
            with open(metrics_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            log_fn(f"epoch {epoch}: loss {train_loss:.5f} mae {train_mae:.5f} "
                   f"val_mae {val_mae:.5f} val_r2 {val_r2:.4f} lr {lr_now:.2e} "
                   f"({rec['structures_per_sec']:.0f} structs/s)")
            if val_mae < best_val:
                best_val, best_epoch = val_mae, epoch
                self.save_checkpoint("best")
            meta = {"epoch": epoch, "best_val": best_val, "best_epoch": best_epoch}
            if sgdr:
                meta.update(sgdr.state_dict())
            self.save_checkpoint("last", meta=meta)
            if epoch - best_epoch >= hyper.patience:
                log_fn(f"early stopping at epoch {epoch} "
                       f"(no val_mae improvement for {hyper.patience} epochs)")
                break
        self.history = history
        return history

    # --- evaluation and prediction -------------------------------------------------

    def _predict_rows(self, binputs: Dict[str, torch.Tensor], n_rows: int,
                      batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pred [n_rows], ga [n_rows, M]) of a device bucket, in batches of
        ``batch_size`` with the last one wrap-padded."""
        preds, gas = [], []
        for s0 in range(0, n_rows, batch_size):
            idx = torch.arange(s0, s0 + batch_size, device=self.device) % n_rows
            pred, ga = self.forward_eval(self.params, {k: v[idx] for k, v in binputs.items()})
            preds.append(pred[:, 0])
            gas.append(ga[..., 0])
        return torch.cat(preds)[:n_rows], torch.cat(gas)[:n_rows]

    def _evaluate_buckets(self, buckets: List[PackedBucket], dev_buckets):
        preds, ys = [], []
        for b, (binputs, _) in zip(buckets, dev_buckets):
            pred, _ = self._predict_rows(binputs, b.num_structures, self.config.hyper.batch_size)
            preds.append(pred.cpu().numpy())
            ys.append(np.asarray(b.targets))
        pred, y = np.concatenate(preds), np.concatenate(ys)
        return float(np.mean(np.abs(pred - y))), r2_score(y, pred), pred, y

    def evaluate(self, test_buckets: List[PackedBucket], report: bool = True) -> dict:
        """Test-set evaluation; writes report.txt and hist_data.json like the
        reference's ``evaluate`` (``scann_model.py:247-313``)."""
        dev = self._put_buckets(test_buckets, "test")
        mae, r2, pred, y = self._evaluate_buckets(test_buckets, dev)
        std, mean = self.config.hyper.target_std, self.config.hyper.target_mean
        result = {"test_mae": mae * std, "test_r2": r2, "target": self.config.hyper.target}
        if report:
            os.makedirs(self.workdir, exist_ok=True)
            with open(os.path.join(self.workdir, "report.txt"), "w") as f:
                if self.history:
                    f.write("Training MAE: " + str(min(self.history["mae"]) * std) + "\n")
                    f.write("Val MAE: " + str(min(self.history["val_mae"]) * std) + "\n")
                f.write(f"Test MAE: {result['test_mae']}, Test R2: {result['test_r2']}")
            hist = {"y_predict": (pred * std + mean).tolist(),
                    "y_true": (y * std + mean).tolist(),
                    "history": self.history or {}}
            with open(os.path.join(self.workdir, "hist_data.json"), "w") as f:
                json.dump(hist, f)
        return result

    def predict(self, buckets: List[PackedBucket], batch_size: Optional[int] = None,
                with_ga: bool = False):
        """Un-standardized predictions (and per-atom GA scores) of the
        buckets' structures, in ascending order of their dataset indices."""
        bs = batch_size or self.config.hyper.batch_size
        all_orig = np.concatenate([np.asarray(b.indices) for b in buckets])
        sorted_orig = np.sort(all_orig)
        if len(np.unique(sorted_orig)) != len(sorted_orig):
            raise ValueError("buckets contain duplicate structure indices")
        preds = np.zeros(len(sorted_orig), np.float32)
        gas: Dict[int, np.ndarray] = {}
        for b, (binputs, _) in zip(buckets, self._put_buckets(buckets, "predict")):
            pred, ga = self._predict_rows(binputs, b.num_structures, bs)
            pos = np.searchsorted(sorted_orig, np.asarray(b.indices))
            preds[pos] = pred.cpu().numpy()
            if with_ga:
                ga = ga.cpu().numpy()
                na = b.inputs["atom_mask"][:, :, 0].sum(-1).astype(int)
                for j, pj in enumerate(pos):
                    gas[int(pj)] = ga[j, : na[j]]
        preds = preds * self.config.hyper.target_std + self.config.hyper.target_mean
        if with_ga:
            return preds, [gas[i] for i in range(len(preds))]
        return preds

    # --- checkpoints -----------------------------------------------------------------

    def _checkpoint_path(self, name: str) -> str:
        return os.path.join(self.workdir, "checkpoints", f"{name}.pt")

    def save_checkpoint(self, name: str = "best", meta: Optional[dict] = None) -> str:
        cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
        payload = {"params": cpu(self.params),
                   "opt_state": {"count": self.step, "mu": cpu(self.mu), "nu": cpu(self.nu)},
                   "step": self.step, "meta": dict(meta or {}),
                   "config": self.config.to_dict()}
        path = self._checkpoint_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        return path

    def restore_checkpoint(self, name: str = "best") -> dict:
        """Load params, Adam state and step; returns the checkpoint's meta."""
        ckpt = torch.load(self._checkpoint_path(name), map_location=self.device,
                          weights_only=True)
        self.load_params(ckpt["params"])
        self.mu = {k: v.to(self.device) for k, v in ckpt["opt_state"]["mu"].items()}
        self.nu = {k: v.to(self.device) for k, v in ckpt["opt_state"]["nu"].items()}
        self.step = int(ckpt["step"])
        return ckpt["meta"]
