"""Training on one GPU, or one rank of a data-parallel job (port of
``scann_tpu/train/loop.py``).

The reference recipe (``scann_model.py:42-319``): RMSE loss plus the Keras
l2(1e-4) kernel penalties, Adam(b1=0.9, b2=0.999, eps=1e-7) with the
``decay=1e-5`` inverse-time factor, cosine or SGDR, early stopping on val
MAE, best-val checkpoints, a test report.

- Each bucket's padded arrays go to the device once, after their index
  ranges are checked on the host (``_put_buckets``), so no launch of a step
  or an eval batch reads anything back; a step gathers its batch there with
  an index vector (``loop.py:340-360``), and each epoch wrap-pads its last
  batch. The loop backward's scratch is kept per batch shape while a live
  bucket has that shape.
- A step takes one of three routes, chosen from (config, M, N) before
  anything is launched (``Trainer.train_route``, the mirror of
  ``eval_route`` and of ``loop.py:384-430``): "fused", ONE launch of the
  molecule backward kernel (forward recompute, residual and every gradient)
  plus its row reduction where its gate passes (M <= 32 at D = 128; widths
  up to 128); else "loop", ONE launch of the crystal loop backward kernel
  where its gate passes (the narrow build M <= 226 at N = 32, D = 128; the
  tall and wide builds M into the thousands, widths up to 256 in their
  ``*_d256`` builds and up to 512 in their ``*_d512`` builds, so a D = 256,
  384 or 512 model trains QM9 (32, 16) here); else "per_layer" (what no gate
  takes: no attention LayerNorm, a plan that does not fit, widths past
  512), the plain model
  under ``torch.autograd``, as the JAX Trainer trains its ``self.model``
  (``loop.py:108-116``); the LocalAttention kernel is for eval, serving and
  prediction. All run at dropout 0.1 on the
  same Philox masks; the raw gradients are scaled by 1 / (n * rmse) and the
  l2 gradient is added, as at ``loop.py:391-427``. A kernel that fails to
  build or launch raises: no route gives way to another at run time. On the
  CPU the same routes run the kernels' plain versions.
- Packed slots (``tpu.structure_packing``, ``data/packing.PackedSlots``):
  a bucket's rows are slots of several structures, its targets [slots, S];
  the device bucket also holds the per-row ``segment_ids`` (computed there
  from the one-hot, nothing read back), which the kernels launch from. A
  step takes ``packed_slot_batch`` slots (about ``batch_size`` structures,
  ``tpu.pack_preserve_batch``), and its RMSE, MAE and gradient scale divide
  by the count of valid segments (``loop.py:341-440``); evaluation and
  prediction keep the valid segments, per structure, in dataset order.
- The epoch order and the dropout seeds come from a ``torch.Generator``
  seeded from (seed, epoch, bucket) alone, so a resumed run replays an
  uninterrupted one exactly (``loop.py:738-751``), packed or not.
- ``version`` counts parameter changes (``init_state``, ``load_params``,
  every optimizer step, a restore); the kernel layout of the weights
  (``pack_params``) is rebuilt when it moved.
- Checkpoints are ``torch.save`` files of params, Adam state, step, the
  run's meta (SGDR state included) and ``config.to_dict()``, loaded with
  ``weights_only=True``.
- Data parallelism (``mesh``, a ``parallel.RankLayout``; by default
  ``make_mesh()`` of the process group, one rank without one): every rank
  holds the same buckets (digest-checked across ranks in
  ``_put_buckets``), parameters and epoch plan; a "fused" or "loop" step
  runs this rank's rows through its kernel (the ``make_sharded_*_train``
  wrappers of ``kernels/sharded.py``, as the JAX Trainer builds its steps
  from them; dropout keyed on the global rows), gathers the predictions and sums the raw
  gradients in rank order, so RMSE, MAE and the gradient scale come from
  the whole batch and every rank applies the same update. The per-layer
  route runs the whole batch on every rank. Eval and predict shard their
  batches the same way. config.yaml, metrics.jsonl, report.txt,
  hist_data.json and the checkpoints are written by rank 0 only.
- ``model.dtype: bfloat16`` trains on the same three routes, as the JAX
  Trainer does: "fused" and "loop" launch the backward kernels in their
  bf16 operand mode (#2, #4; ``kernels/dots.py``), "per_layer"
  differentiates the eager model in the flax bf16 semantics
  (``models.scann``). It evaluates through the forward kernels in that mode
  (#1, #3) and the per-layer model on bfloat16 tensors (#5). Params, Adam
  state and the l2 term stay f32, as in the JAX package.
- Warm start: ``tpu.exec_cache_dir`` points the kernel build cache there
  (``utils/exec_cache.py``); ``fit`` builds every kernel (or loads it from
  the cache) before its first step, one nvcc each, all at once.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from scann_tpu_torch.compat.from_jax import params_from_jax
from scann_tpu_torch.config import ScannConfig, save_config
from scann_tpu_torch.data.packing import packed_slot_batch
from scann_tpu_torch.data.pipeline import PackedBucket
from scann_tpu_torch.kernels import local_attention as kla
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.kernels.sharded import (
    eval_rows,
    make_sharded_loop_forward,
    make_sharded_loop_train,
    make_sharded_scann_train,
)
from scann_tpu_torch.kernels.scann_backward import (
    fused_scann_train_grads,
    grads_from_flat,
    launch_scann_backward,
)
from scann_tpu_torch.kernels.scann_forward import (
    dropout_masks_for,
    launch_scann_forward,
    pack_params,
    segment_count,
)
from scann_tpu_torch.kernels.scann_loop import (
    launch_loop_backward,
    launch_loop_forward,
    loop_scann_train_grads,
)
from scann_tpu_torch.ops.attention import segment_ids
from scann_tpu_torch.parallel.distributed import check_replicas_match, is_primary
from scann_tpu_torch.parallel.mesh import RankLayout, make_mesh
from scann_tpu_torch.models.scann import (
    check_index_ranges,
    init_params,
    l2_penalty,
    param_shapes,
    regularized_keys,
    scann_forward,
)
from scann_tpu_torch.train.schedules import SGDRSchedule, make_cosine_lr

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-7   # Keras Adam (scann_model.py:212)
TRAIN_DROPOUT = 0.1


def bucket_structure_indices(b) -> np.ndarray:
    """Per-structure dataset indices of a bucket, in its row order: a packed
    bucket's valid segments in (slot, segment) order (its [slots, S]
    indices hold -1 for an empty segment)."""
    ix = np.asarray(b.indices)
    return ix[ix >= 0] if ix.ndim == 2 else ix[: b.num_structures]


def bucket_structure_targets(b) -> np.ndarray:
    """Per-structure targets aligned with ``bucket_structure_indices``."""
    y = np.asarray(b.targets)
    if y.ndim == 2:
        return y[np.asarray(b.indices) >= 0]
    return y[: b.num_structures]


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


def bucket_shape(b: PackedBucket) -> Tuple[int, int, int]:
    """(M, N, S) of a bucket (S: its segments a slot, 0 unpacked)."""
    seg = b.inputs.get("segment_onehot")
    return (*b.shape, 0 if seg is None else seg.shape[2])


class Trainer:
    """Parameters, Adam state and the train / eval / predict loops of one
    config on one device: one rank of ``mesh``."""

    def __init__(self, config: ScannConfig, device="cuda", workdir: Optional[str] = None,
                 mesh: Optional[RankLayout] = None):
        self.config = config
        self.mesh = mesh if mesh is not None else make_mesh(
            config.tpu.mesh_shape[0] if config.tpu.mesh_shape else None)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = self.mesh.device      # the rank's own card
        self.exec_cache = None
        if config.tpu.exec_cache_dir:
            from scann_tpu_torch.kernels import _build

            self.exec_cache = _build.set_build_dir(config.tpu.exec_cache_dir)
        self.mrelu_head = config.hyper.target == "e_b"
        self.workdir = workdir or "{}_{}".format(config.hyper.save_path, config.hyper.target)
        self.dropout_rate = TRAIN_DROPOUT
        # a data-parallel job's steps and loop eval: the sharded wrappers, each
        # running this Trainer's own launch on the rank's rows (its route's
        # kernel, its cached weight layout and scratch, its dropout rate)
        self._sharded_train: Dict[str, Callable] = {}
        self._sharded_loop_fwd: Optional[Callable] = None
        if self.mesh.world > 1:
            def local(route):
                return lambda params, x, y, seed, base: self._whole_model_grads(
                    route, x, y, seed, base)

            cfm = config.model
            self._sharded_train = {
                "fused": make_sharded_scann_train(self.mesh, cfm, self.mrelu_head,
                                                  local=local("fused")),
                "loop": make_sharded_loop_train(self.mesh, cfm, self.mrelu_head,
                                                local=local("loop"))}
            self._sharded_loop_fwd = make_sharded_loop_forward(
                self.mesh, cfm, self.mrelu_head, local=self.forward_eval)
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}
        self.step = 0
        self.version = 0
        self._packed: Optional[Tuple[int, Dict[str, torch.Tensor]]] = None
        self._device_buckets: Dict[Tuple[str, int], tuple] = {}
        self._loop_scratch: Dict[Tuple[int, int, int, int], dict] = {}
        self._slot_batch: Optional[int] = None
        self.history: Optional[Dict[str, list]] = None

    # --- parameters and optimizer state ---------------------------------------

    def load_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Take a copy of ``params`` (flat dict keyed like ``param_shapes``)
        with a fresh Adam state at step 0: the optimizer updates the copy in
        place, never the caller's tensors."""
        want = param_shapes(self.config.model)
        if set(params) != set(want):
            raise ValueError(f"parameter keys do not match the config: "
                             f"{sorted(set(params) ^ set(want))}")
        bad = {k: (tuple(params[k].shape), want[k]) for k in want
               if tuple(params[k].shape) != want[k]}
        if bad:
            raise ValueError(f"parameter shapes do not match the config (got, expected): {bad}")
        self.params = {k: params[k].to(self.device, torch.float32, copy=True).contiguous()
                       for k in want}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.step = 0
        self.version += 1
        return self.params

    def init_state(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Random parameters with the Keras initializers, from ``seed``."""
        return self.load_params(init_params(self.config.model, torch.Generator().manual_seed(seed)))

    def load_optimizer(self, count: int, mu, nu) -> None:
        """Install an Adam state carried over from another run (a reference
        H5: ``compat.load_h5_optimizer``). ``mu`` and ``nu`` are flax-layout
        trees like the parameters', checked key for key and shape for shape
        against the config (a ``ValueError`` on a mismatch). ``count``
        becomes ``step``: the next ``_adam`` applies t = count + 1, and the
        inverse-time decay ``lr / (1 + adam_decay * step)`` goes on along the
        reference's trajectory (JAX ``Trainer.load_optimizer``)."""
        if self.params is None:
            raise RuntimeError("load params before the optimizer state "
                               "(Trainer.load_params / init_state)")
        cfm = self.config.model
        self.mu = params_from_jax(mu, cfm, self.device)
        self.nu = params_from_jax(nu, cfm, self.device)
        self.step = int(count)

    def kernel_params(self) -> Dict[str, torch.Tensor]:
        """The whole-model kernels' layout of the current weights (the
        molecule and the crystal kernel share it), rebuilt when ``version``
        moved since it was built."""
        if self._packed is None or self._packed[0] != self.version:
            self._packed = (self.version, pack_params(self.params, self.config.model))
        return self._packed[1]

    def shape_libraries(self, shapes, training: bool = False) -> Tuple[str, ...]:
        """The builds made for some shapes only (``_build.SHAPE_SOURCES``:
        the wide and tall builds, #4's in the model's operand mode, the
        forwards' builds of widths past 128) that batches of these (M, N, S)
        shapes launch, by their routes: the molecule forward's, the loop
        forward's and the per-layer kernel's in eval, the loop backward's in
        training; the kernel modules name each route's build
        (``kfwd.library``, ``kloop.forward_library``, ``kla.library``,
        ``kloop.backward_library``)."""
        from scann_tpu_torch.kernels._build import SHAPE_SOURCES

        cfm = self.config.model
        libs = set()
        for M, N, S in shapes:
            route = self.eval_route(M, N, S)
            if route == "fused":
                libs.add(kfwd.library(cfm))
            if route == "loop":
                libs.add(kloop.forward_library(cfm, M, N, S)[0])
            if route == "per_layer":
                libs.add(kla.library(N, cfm.local_dim))
            if training and self.train_route(M, N, S) == "loop":
                libs.add(kloop.backward_library(cfm, M, N, S))
        return tuple(sorted(libs & set(SHAPE_SOURCES)))

    def eval_route(self, M: int, N: int, S: int = 0) -> str:
        """Which forward a CUDA batch of shape (M, N) at S segments a slot
        (0: unpacked) takes, from the kernels' gates alone: "fused" (the
        whole-model molecule kernel), "loop" (the whole-model crystal
        kernel) or "per_layer" (the eager model with one LocalAttention
        kernel launch per layer)."""
        cfm = self.config.model
        if kfwd.refusal(cfm, M, N, S) is None:
            return "fused"
        if kloop.refusal(cfm, M, N, S) is None:
            return "loop"
        return "per_layer"

    def forward_eval(self, params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Deterministic forward -> (property [B, 1], or [B, S] for packed
        slots; ga_score [B, M, 1]).

        On CUDA the route is chosen from (config, M, N) before anything is
        launched (``eval_route``): the whole-model kernel where its gate
        passes, else the crystal loop kernel where its gate passes, else the
        per-layer model. Nothing is read back: the batch's index ranges are
        checked where it entered (``_put_buckets``, ``Scann.forward_eval``).
        A kernel that fails to build or launch raises; nothing falls back. On
        the CPU it is the eager model."""
        cfm = self.config.model
        with torch.inference_mode():
            if self.device.type != "cuda":
                return scann_forward(params, batch, cfm, self.mrelu_head)
            route = self.eval_route(batch["atomic"].shape[1], batch["neighbors"].shape[2],
                                    segment_count(batch))
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
        (the loss is RMSE + l2, as the JAX step reports it). For packed slots
        (y [B, S]) RMSE, MAE and the gradient scale count the valid segments
        only (``segment_mask``), as ``loop.py:371-379`` does. On a rank of a
        data-parallel job ``raw_grads`` returns the whole batch's
        predictions and gradients, so the sums of err^2, |err| and n are
        global, and every rank applies the same update."""
        l2 = self.config.hyper.l2_reg
        pred, raw = self.raw_grads(batch, y, seed)
        if "segment_mask" in batch:
            smask = batch["segment_mask"]
            n = smask.sum()
            err = (pred - y) * smask
            rmse = torch.sqrt(torch.sum(err * err) / n)
            mae = torch.sum(torch.abs(err)) / n
        else:
            n = y.shape[0]
            err = pred - y
            rmse = torch.sqrt(torch.mean(err * err))
            mae = torch.mean(torch.abs(err))
        loss = rmse + l2_penalty(self.params, l2)
        keys = list(self.params)
        grads = [raw[k] for k in keys]
        torch._foreach_mul_(grads, 1.0 / (n * rmse))
        reg = regularized_keys(self.params)
        torch._foreach_add_([raw[k] for k in reg], [self.params[k] for k in reg], alpha=2 * l2)
        self._adam(keys, grads, lr)
        return loss.detach(), mae.detach()

    def train_route(self, M: int, N: int, S: int = 0) -> str:
        """Which backward a training batch of shape (M, N) at S segments a
        slot (0: unpacked) takes, from the kernels' gates alone: "fused"
        (the whole-model molecule backward), "loop" (the whole-model crystal
        loop backward) or "per_layer" (the plain model under
        ``torch.autograd``)."""
        cfm = self.config.model
        if kbwd.refusal(cfm, M, N, S) is None:
            return "fused"
        if kloop.backward_refusal(cfm, M, N, S) is None:
            return "loop"
        return "per_layer"

    def raw_grads(self, batch: Dict[str, torch.Tensor], y: torch.Tensor, seed: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(pred [B], or [B, S] for packed slots, gradients of 0.5 *
        sum((pred - y)^2) over the valid segments) at the training dropout,
        by the route of ``train_route``: on CUDA one launch of the
        molecule or the loop backward kernel (the loop kernel's scratch is
        kept per batch shape), or the plain model under autograd; on the
        CPU the kernels' plain versions. Nothing is read back: ``fit``'s
        batches come from buckets whose index ranges ``_put_buckets``
        checked."""
        M, N = batch["atomic"].shape[1], batch["neighbors"].shape[2]
        route = self.train_route(M, N, segment_count(batch))
        if route == "per_layer":
            return self._per_layer_grads(batch, y, seed)
        if self._sharded_train:
            return self._sharded_train[route](self.params, batch, y, seed)
        return self._whole_model_grads(route, batch, y, seed, 0)

    def _whole_model_grads(self, route: str, batch: Dict[str, torch.Tensor], y: torch.Tensor,
                           seed: int, mol_base: int
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``raw_grads`` of the "fused" or "loop" route on ``batch``, whose
        first row is global row ``mol_base`` of the step's batch (the
        dropout masks' key)."""
        cfm = self.config.model
        B, M = batch["atomic"].shape[:2]
        N = batch["neighbors"].shape[2]
        S = segment_count(batch)
        if self.device.type == "cuda":
            packed = self.kernel_params()
            if route == "fused":
                flat, pred = launch_scann_backward(packed, batch, cfm, y, None, True,
                                                   self.mrelu_head, self.dropout_rate, seed,
                                                   mol_base)
            else:
                # S picks the build (``is_tall_backward``) and the scratch's shape
                scratch = self._loop_scratch.get((B, M, N, S))
                if scratch is None:
                    scratch = self._loop_scratch[(B, M, N, S)] = kloop.loop_backward_scratch(
                        packed, cfm, B, M, N, S=S)
                flat, pred = launch_loop_backward(packed, batch, cfm, y, None, True,
                                                  self.mrelu_head, self.dropout_rate, seed,
                                                  mol_base, scratch=scratch)
            return (pred.view(B, S) if S else pred), grads_from_flat(flat, packed, cfm)
        grads_fn = fused_scann_train_grads if route == "fused" else loop_scann_train_grads
        pred, raw = grads_fn(self.params, batch, y, cfm, self.mrelu_head, self.dropout_rate, seed,
                             mol_base)
        return (pred if S else pred[:, 0]), raw

    def _per_layer_grads(self, batch: Dict[str, torch.Tensor], y: torch.Tensor, seed: int
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The third route: the plain model's training forward
        differentiated by ``torch.autograd``, which keeps each layer's
        activations for the backward (the JAX Trainer's ``self.model``; the
        LocalAttention kernel keeps nothing, so its backward would recompute
        the plain layer after its forward); the same residual (an empty
        segment's zeroed) and the same dropout masks as the whole-model
        kernels. At ``model.dtype: bfloat16`` the model computes in the flax
        bf16 semantics and the f32 params get f32 gradients, as
        ``jax.value_and_grad`` of the flax bf16 model gives them."""
        cfm = self.config.model
        masks = dropout_masks_for(cfm, batch, self.dropout_rate, seed)
        packed = "segment_onehot" in batch
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
            pred, _ = scann_forward(leaves, batch, cfm, self.mrelu_head, masks)
            err = (pred - y) * kbwd.segment_valid(batch) if packed else pred[:, 0] - y
            loss = 0.5 * (err ** 2).sum()
            grads = torch.autograd.grad(loss, list(leaves.values()))
        pred = pred.detach()
        return (pred if packed else pred[:, 0]), dict(zip(leaves, grads))

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
        """Bucket arrays on the device, once per (tag, bucket), their index
        ranges checked on the host first (so no launch on them reads
        anything back); the entry keeps the bucket alive so its id() cannot
        be reused by another one. A packed bucket also gets its
        ``segment_ids`` [slots, M], computed on the device from the one-hot.
        On a rank of a data-parallel job each bucket's host copy is first
        checked against every other rank's (a crc32 digest each,
        ``parallel.check_replicas_match``). Buckets of ``tag`` not in
        ``buckets`` are dropped, and with them the loop scratch of shapes no
        live bucket has."""
        live = {(tag, id(b)) for b in buckets}
        for key in [k for k in self._device_buckets if k[0] == tag and k not in live]:
            del self._device_buckets[key]
        out = []
        for b in buckets:
            key = (tag, id(b))
            if key not in self._device_buckets:
                check_replicas_match({"inputs": b.inputs, "targets": b.targets},
                                     what=f"{tag} bucket")
                check_index_ranges(b.inputs, self.config.model)
                inputs = _to_device(b.inputs, self.device)
                if "segment_onehot" in inputs:
                    inputs["segment_ids"] = segment_ids(inputs["segment_onehot"])
                self._device_buckets[key] = (
                    b, inputs,
                    torch.as_tensor(np.asarray(b.targets, np.float32), device=self.device))
            out.append(self._device_buckets[key][1:])
        self._prune_loop_scratch()
        return out

    def _prune_loop_scratch(self) -> None:
        """Drop the loop backward's scratch of every (B, M, N, S) whose (M,
        N, S) no device bucket has (it holds 1.5 GB at the MP2018 batch)."""
        shapes = {(*v[0].shape, segment_count(v[1])) for v in self._device_buckets.values()}
        for key in [k for k in self._loop_scratch if k[1:] not in shapes]:
            del self._loop_scratch[key]

    # --- training ------------------------------------------------------------------

    def fit(self, train_buckets: List[PackedBucket], valid_buckets: List[PackedBucket],
            epochs: Optional[int] = None, log_fn=print, resume: bool = False) -> Dict[str, list]:
        """Train; ``resume=True`` continues from the workdir's 'last'
        checkpoint (params, Adam state, step and schedule). Batches are of
        rows (slots): for packed slots ``packed_slot_batch`` of them, so a
        step sees about ``batch_size`` structures (``tpu.pack_preserve_batch``,
        ``loop.py:647-665``)."""
        hyper = self.config.hyper
        epochs = epochs or hyper.epochs
        bs = hyper.batch_size
        n_train = sum(b.num_structures for b in train_buckets)
        n_rows = sum(len(b.targets) for b in train_buckets)
        if n_train > n_rows and self.config.tpu.pack_preserve_batch:
            bs = packed_slot_batch(hyper.batch_size, n_rows, n_train, self.mesh.world)
        if bs % self.mesh.world:
            raise ValueError(f"batch of {bs} rows does not split over {self.mesh.world} ranks: "
                             "hyper.batch_size must be a multiple of the world size")
        self._slot_batch = bs
        steps_per_epoch = sum(-(-len(b.targets) // bs) for b in train_buckets)
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
        if self.device.type == "cuda":
            from scann_tpu_torch.kernels import _build

            _build.build_all(_build.SOURCES + self.shape_libraries(
                [bucket_shape(b) for b in train_buckets], training=True)
                + self.shape_libraries([bucket_shape(b) for b in valid_buckets]))

        self.config.tpu.observed_buckets = [
            list(s) for s in sorted({b.shape for b in list(train_buckets) + list(valid_buckets)})]
        primary = is_primary()
        if primary:  # exactly-once artifacts of a multi-process run
            os.makedirs(self.workdir, exist_ok=True)
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
            if primary:
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            log_fn(f"epoch {epoch}: loss {train_loss:.5f} mae {train_mae:.5f} "
                   f"val_mae {val_mae:.5f} val_r2 {val_r2:.4f} lr {lr_now:.2e} "
                   f"({rec['structures_per_sec']:.0f} structs/s)")
            if val_mae < best_val:
                best_val, best_epoch = val_mae, epoch
                if primary:
                    self.save_checkpoint("best")
            meta = {"epoch": epoch, "best_val": best_val, "best_epoch": best_epoch}
            if sgdr:
                meta.update(sgdr.state_dict())
            if primary:
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
        """(pred [n_rows], or [n_rows, S] for packed slots; ga [n_rows, M])
        of a device bucket, in batches of ``batch_size`` rows with the last
        one wrap-padded; on a rank of a data-parallel job each batch is
        sharded (``eval_batch``)."""
        packed = "segment_onehot" in binputs
        preds, gas = [], []
        for s0 in range(0, n_rows, batch_size):
            idx = torch.arange(s0, s0 + batch_size, device=self.device) % n_rows
            pred, ga = self.eval_batch({k: v[idx] for k, v in binputs.items()})
            preds.append(pred if packed else pred[:, 0])
            gas.append(ga[..., 0])
        return torch.cat(preds)[:n_rows], torch.cat(gas)[:n_rows]

    def eval_batch(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward_eval`` of the current parameters on one batch of the
        Trainer's own eval and predict; on a rank of a data-parallel job
        this rank's rows of a whole-model route, gathered in rank order (the
        per-layer route runs the whole batch on every rank)."""
        M, N = batch["atomic"].shape[1], batch["neighbors"].shape[2]
        route = self.eval_route(M, N, segment_count(batch))
        if self.mesh.world == 1 or route == "per_layer":
            return self.forward_eval(self.params, batch)
        if route == "loop":
            return self._sharded_loop_fwd(self.params, batch)
        with torch.inference_mode():
            return eval_rows(self.mesh, lambda x: self.forward_eval(self.params, x), batch)

    def _evaluate_buckets(self, buckets: List[PackedBucket], dev_buckets):
        """(mae, r2, pred, y) over the buckets' structures: for packed slots
        the valid segments, per structure (``loop.py:803-820``)."""
        preds, ys = [], []
        bs = self._slot_batch or self.config.hyper.batch_size
        for b, (binputs, _) in zip(buckets, dev_buckets):
            pred, _ = self._predict_rows(binputs, len(b.targets), bs)
            pred = pred.cpu().numpy()
            if pred.ndim == 2:
                pred = pred[np.asarray(b.indices) >= 0]
            preds.append(pred)
            ys.append(bucket_structure_targets(b))
        pred, y = np.concatenate(preds), np.concatenate(ys)
        return float(np.mean(np.abs(pred - y))), r2_score(y, pred), pred, y

    def evaluate(self, test_buckets: List[PackedBucket], report: bool = True) -> dict:
        """Test-set evaluation; writes report.txt and hist_data.json like the
        reference's ``evaluate`` (``scann_model.py:247-313``)."""
        dev = self._put_buckets(test_buckets, "test")
        mae, r2, pred, y = self._evaluate_buckets(test_buckets, dev)
        std, mean = self.config.hyper.target_std, self.config.hyper.target_mean
        result = {"test_mae": mae * std, "test_r2": r2, "target": self.config.hyper.target}
        if report and is_primary():
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
        buckets' structures, in ascending order of their dataset indices;
        packed slots give one per valid segment (``loop.py:856-935``)."""
        bs = batch_size or self.config.hyper.batch_size
        all_orig = np.concatenate([bucket_structure_indices(b) for b in buckets])
        sorted_orig = np.sort(all_orig)
        if len(np.unique(sorted_orig)) != len(sorted_orig):
            raise ValueError("buckets contain duplicate structure indices")
        preds = np.zeros(len(sorted_orig), np.float32)
        gas: Dict[int, np.ndarray] = {}
        for b, (binputs, _) in zip(buckets, self._put_buckets(buckets, "predict")):
            pred, ga = self._predict_rows(binputs, len(b.targets), bs)
            pred = pred.cpu().numpy()
            pos = np.searchsorted(sorted_orig, bucket_structure_indices(b))
            packed = pred.ndim == 2
            valid = np.asarray(b.indices) >= 0
            preds[pos] = pred[valid] if packed else pred
            if with_ga:
                ga = ga.cpu().numpy()
                if packed:
                    # structure j's rows: its segment's column of the one-hot,
                    # a contiguous run in (slot, row) order
                    sl, sg = np.nonzero(valid)
                    member = b.inputs["segment_onehot"][sl, :, sg] > 0     # [n, M]
                    parts = np.split(ga[sl][member], np.cumsum(member.sum(1))[:-1])
                    for j, pj in enumerate(pos):
                        gas[int(pj)] = parts[j]
                else:
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
