"""Data-parallel wrappers of the whole-model kernels (port of
``scann_tpu/kernels/shard_util.py`` and the ``make_sharded_*`` wrappers of
``scann_tpu/kernels/scann_backward.py:752,840`` and
``scann_tpu/kernels/scann_loop.py:1242-1329``).

The JAX wrappers ``shard_map`` a kernel over the ``data`` axis of a mesh:
parameters replicated, the batch sharded, the raw gradients ``psum``-ed.
Here each process is one rank (``parallel.make_mesh``): every rank holds
the whole batch (replicated buckets, one epoch plan), takes its rows
(``parallel.batch_shard``: the rank-th of ``world`` equal contiguous
slices) and runs them through the same CUDA launch a single process
would: #2 for ``make_sharded_scann_train`` and ``_apply``, #4 for
``make_sharded_loop_train`` and ``_apply``, #3 for
``make_sharded_loop_forward``. As in the JAX package, the Trainer builds
its sharded steps from the two ``_train`` wrappers and its sharded loop
eval from ``make_sharded_loop_forward``, each given the Trainer's own
launch as ``local``; its sharded molecule eval (#1) is ``eval_rows``. On
CPU tensors the same wrappers run the plain versions.

- Dropout: a rank's masks start at ``mol_base = rank * b_local``
  (``ops/dropout.make_dropout_masks`` keys each mask on the molecule's
  global row), the role of JAX's ``seed + axis_index * b_local``, so the
  masks equal those of the whole batch.
- Reduction: the raw gradients are flattened into one vector, gathered
  from every rank (``parallel.distributed.gather_ordered``, through a host
  copy on gloo) and summed from rank 0 up, so a run repeats bit for bit
  and equals one process that runs the shards in rank order.
- Predictions (and GA scores) are gathered in rank order.

``lazy_sharded``'s cache of ``shard_map`` instances has no counterpart:
nothing here is traced. Nor has the JAX wrappers' ``interpret`` argument.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.kernels.scann_backward import (
    fused_scann_grad,
    fused_scann_train_grads,
)
from scann_tpu_torch.kernels.scann_forward import fused_scann_forward, segment_count
from scann_tpu_torch.kernels.scann_loop import (
    loop_scann_forward,
    loop_scann_grad,
    loop_scann_train_grads,
)
from scann_tpu_torch.parallel.distributed import gather_ordered
from scann_tpu_torch.parallel.mesh import RankLayout, batch_sharding

Grads = Dict[str, torch.Tensor]


def local_rows(mesh: RankLayout, inputs: Dict[str, torch.Tensor]
               ) -> Tuple[slice, Dict[str, torch.Tensor]]:
    """(this rank's row slice, its rows of every input); ``segment_mask``
    is sliced with the rest."""
    rows = batch_sharding(mesh, inputs["atomic"].shape[0])
    return rows, {k: v[rows] for k, v in inputs.items()}


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t``, concatenated in rank order."""
    return torch.cat(gather_ordered(t))


def reduce_ordered(grads: Grads) -> Grads:
    """The sum over ranks of each gradient, added from rank 0 up: one
    gather of the flattened gradients, then ``g0 + g1 + ...``."""
    keys = list(grads)
    flat = torch.cat([grads[k].reshape(-1) for k in keys])
    parts = gather_ordered(flat)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    out, at = {}, 0
    for k in keys:
        n = grads[k].numel()
        out[k] = total[at:at + n].view_as(grads[k])
        at += n
    return out


def train_rows(mesh: RankLayout, local_fn: Callable, inputs: Dict[str, torch.Tensor],
               targets: torch.Tensor) -> Tuple[torch.Tensor, Grads]:
    """(pred of the whole batch, raw gradients summed over ranks) of
    ``local_fn(rows, targets of those rows, mol_base) -> (pred, grads)``
    run on this rank's rows."""
    rows, local = local_rows(mesh, inputs)
    pred, raw = local_fn(local, targets[rows], rows.start)
    return gather_rows(pred), reduce_ordered(raw)


def eval_rows(mesh: RankLayout, local_fn: Callable, inputs: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pred, ga) of the whole batch from ``local_fn(rows) -> (pred, ga)``
    run on this rank's rows."""
    _, local = local_rows(mesh, inputs)
    pred, ga = local_fn(local)
    return gather_rows(pred), gather_rows(ga)


def _train_wrapper(mesh: RankLayout, grads_fn: Callable, cfm: ModelConfig, mrelu_head: bool,
                   dropout_rate: float, local: Optional[Callable]) -> Callable:
    if local is None:
        def local(params, x, y, seed, base):
            return grads_fn(params, x, y.reshape(y.shape[0], -1), cfm, mrelu_head,
                            dropout_rate, seed or 0, mol_base=base)

    def wrapper(params: Grads, inputs: Dict[str, torch.Tensor], targets, seed):
        targets = torch.as_tensor(targets, dtype=torch.float32,
                                  device=inputs["atomic"].device)
        return train_rows(mesh, lambda x, y, base: local(params, x, y, seed, base),
                          inputs, targets)

    return wrapper


def make_sharded_scann_train(mesh: RankLayout, cfm: ModelConfig, mrelu_head: bool = False,
                             dropout_rate: float = 0.0, local: Optional[Callable] = None
                             ) -> Callable:
    """Data-parallel one-kernel training step (#2): ``wrapper(params,
    inputs, targets, seed) -> (pred [B, 1] or [B, S] gathered, raw
    gradients of 0.5 * sum((pred - t)^2) summed over ranks)``; the caller
    applies the global 1 / (n * rmse) scale and the l2 term.

    ``local(params, rows, their targets, seed, mol_base) -> (pred, raw)``
    is one rank's step on its rows; by default ``fused_scann_train_grads``
    at ``mrelu_head`` and ``dropout_rate``, which packs the parameters and
    checks the rows' index ranges each call. The Trainer passes its own
    launch, on its cached kernel layout of the weights."""
    return _train_wrapper(mesh, fused_scann_train_grads, cfm, mrelu_head, dropout_rate, local)


def make_sharded_loop_train(mesh: RankLayout, cfm: ModelConfig, mrelu_head: bool = False,
                            dropout_rate: float = 0.0, local: Optional[Callable] = None
                            ) -> Callable:
    """``make_sharded_scann_train`` by the crystal loop backward (#4); the
    Trainer's ``local`` also keeps the kernel's scratch per batch shape."""
    return _train_wrapper(mesh, loop_scann_train_grads, cfm, mrelu_head, dropout_rate, local)


def make_sharded_loop_forward(mesh: RankLayout, cfm: ModelConfig, mrelu_head: bool = False,
                              local: Optional[Callable] = None) -> Callable:
    """Data-parallel eval by the crystal loop forward (#3): ``wrapper(params,
    inputs) -> (pred, ga)`` of the whole batch, gathered in rank order.
    ``local(params, rows) -> (pred, ga)`` is one rank's forward; by default
    ``loop_scann_forward``, the Trainer passes its ``forward_eval``."""
    if local is None:
        def local(params, x):
            return loop_scann_forward(params, x, cfm, mrelu_head)

    def wrapper(params: Grads, inputs: Dict[str, torch.Tensor]):
        with torch.inference_mode():
            return eval_rows(mesh, lambda x: local(params, x), inputs)

    return wrapper


class _ShardedApply(torch.autograd.Function):
    """Forward: this rank's rows through the forward kernel, gathered.
    Backward: this rank's rows of the cotangents through the backward
    kernel, the gradients summed over ranks in rank order (the transpose of
    JAX's replicated parameter spec)."""

    @staticmethod
    def forward(ctx, spec, inputs, *values):
        mesh, keys, forward_fn, grad_fn, seed = spec
        rows, local = local_rows(mesh, inputs)
        pred, ga = forward_fn(dict(zip(keys, values)), local, seed, rows.start)
        ctx.spec, ctx.rows, ctx.local = spec, rows, local
        ctx.save_for_backward(*values)
        return gather_rows(pred), gather_rows(ga)

    @staticmethod
    def backward(ctx, d_pred, d_ga):
        mesh, keys, _, grad_fn, seed = ctx.spec
        rows, local = ctx.rows, ctx.local
        values = ctx.saved_tensors
        b, M = local["atomic"].shape[:2]
        dev = values[0].device
        S = max(segment_count(local), 1)
        ct_pred = d_pred[rows] if d_pred is not None else torch.zeros(b, S, device=dev)
        ct_ga = d_ga[rows] if d_ga is not None else torch.zeros(b, M, 1, device=dev)
        grads = reduce_ordered(grad_fn(dict(zip(keys, values)), local, ct_pred, ct_ga, seed,
                                       rows.start))
        return (None, None, *[grads[k] for k in keys])


def _apply_wrapper(mesh: RankLayout, forward: Callable, grad: Callable, cfm: ModelConfig,
                   mrelu_head: bool, dropout_rate: float) -> Callable:
    def forward_fn(params, x, seed, base):
        return forward(params, x, cfm, mrelu_head, dropout_rate, seed, mol_base=base)

    def grad_fn(params, x, ct_pred, ct_ga, seed, base):
        # mrelu head: straight-through, so the cotangent passes unchanged
        return grad(params, x, cfm, ct_pred, ct_ga, dropout_rate, seed, mol_base=base)

    def wrapper(params: Grads, inputs: Dict[str, torch.Tensor], seed):
        keys = tuple(params)
        return _ShardedApply.apply((mesh, keys, forward_fn, grad_fn, seed or 0), inputs,
                                   *[params[k] for k in keys])

    return wrapper


def make_sharded_scann_apply(mesh: RankLayout, cfm: ModelConfig, mrelu_head: bool = False,
                             dropout_rate: float = 0.0) -> Callable:
    """Differentiable data-parallel forward: ``wrapper(params, inputs, seed)
    -> (pred, ga)`` gathered; ``torch.autograd`` through it runs the
    molecule backward kernel (#2) on each rank's rows and sums the
    parameter gradients over ranks."""
    return _apply_wrapper(mesh, fused_scann_forward, fused_scann_grad, cfm, mrelu_head,
                          dropout_rate)


def make_sharded_loop_apply(mesh: RankLayout, cfm: ModelConfig, mrelu_head: bool = False,
                            dropout_rate: float = 0.0) -> Callable:
    """``make_sharded_scann_apply`` by the crystal loop kernels (#3, #4)."""
    return _apply_wrapper(mesh, loop_scann_forward, loop_scann_grad, cfm, mrelu_head,
                          dropout_rate)
