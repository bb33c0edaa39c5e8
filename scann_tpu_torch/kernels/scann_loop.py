"""Whole-model SCANN forward and backward for crystals on the GPU: the
wrappers around ``csrc/scann_loop.cu`` and ``csrc/scann_loop_backward.cu``.

Replaces ``scann_tpu/kernels/scann_loop.py`` (the Pallas TPU kernels that run
the whole model with a ``fori_loop`` over its layers: ``_fwd_kernel`` and
``_bwd_kernel``) for unpacked batches whose structures are too large for the
molecule kernels of ``kernels.scann_forward`` / ``kernels.scann_backward``:
MP2018 at (M=96, N=32, 9 layers), Pt/graphene at (M=128, N=32, 11 layers,
ring features).

Forward:

- ``loop_scann_forward(params, inputs, cfm, mrelu_head, dropout_rate,
  dropout_seed)`` keeps the JAX signature and layout: (property [B, 1],
  ga_score [B, M, 1]), f32. For CUDA tensors it launches the kernel (or
  raises); for CPU tensors it runs the plain version,
  ``reference_loop_forward``: the eager model with the Philox masks of
  ``ops.dropout`` at a rate above 0. ``launch_loop_forward.launches`` counts
  kernel launches.
- The gate (``check_supported``) is the kernel's own shared-memory plan
  (``loop_memory_plan``). On the TPU the two whole-model kernels differ in
  compile time (unrolled layers against a loop); here both loop at run time
  and differ in where a structure's state lives. This kernel keeps only the
  current centers [M, max(D, G)] in shared memory for a whole layer and every
  other per-atom tensor for one block of 32, 16 or 8 atoms at a time, so it
  needs M * 520 bytes + 107 to 131 KB at D = G = 128: M <= 232 (at N = 32)
  fits a block's 227 KB, and larger structures go through the per-layer
  kernel of ``kernels.local_attention``. It shares the molecule kernel's tiles: chunks
  of at most 64 (atom, neighbour) rows (N <= 64), D, G, O multiples of 4 up
  to 128, float32. Packed batches (``segment_onehot``) and
  ``use_attn_norm=False`` are refused.

Backward (crystal training):

- ``loop_scann_grad(params, inputs, cfm, ct_pred, ct_ga, dropout_rate,
  dropout_seed)``: the parameter gradients of (pred, ga) contracted with the
  cotangents. ``loop_scann_train_grads(params, inputs, targets, cfm,
  mrelu_head, dropout_rate, dropout_seed)``: the one-shot training step,
  forward, residual and backward in one launch -> (pred [B, 1], raw gradients
  of 0.5 * sum((pred - t)^2)); mrelu is straight-through. ``loop_scann_apply``
  is a ``torch.autograd.Function``: forward = the loop forward kernel,
  backward = the loop backward kernel, on the same dropout masks. Gradients
  come back as a flat dict keyed like the params. CUDA tensors launch the
  kernel (``launch_loop_backward``, whose ``.launches`` counts launches: the
  backward kernel plus its row reduction) or raise; CPU tensors run the plain
  versions ``reference_loop_grad`` / ``reference_loop_train_grads``: the eager
  training forward under ``torch.autograd``, the code of
  ``kernels.scann_backward.reference_fused_scann_*``.
- Its gate (``backward_refusal``) is again the kernel's own plan
  (``loop_backward_memory_plan``): one resident [M, max(D, G)] buffer (the
  centers going forward, the accumulating d(layer input) going back), five
  slots for a block of 32, 16 or 8 atoms, and a work region for a chunk of at
  most 32 (atom, neighbour) rows, so N <= 32 and, at D = G = 128 and N = 32,
  M <= 106 with blocks of 32, M <= 186 with blocks of 16 and M <= 226 with
  blocks of 8: lower than the forward's 232. Beyond it a bucket trains
  through the per-layer model under ``torch.autograd``
  (``Trainer.train_route``).
- A cluster of C thread blocks works on each structure, each block on its
  share of the atoms (``cluster_size``: C is a function of the batch size
  alone, 2 at the MP2018 batch of 64, so that the batch fills the card's 132
  SMs in one wave). Launches at one C repeat bit for bit; two values of C
  differ in the last bits, each within the same tolerance of the plain
  version. The products run on the tensor cores as split-TF32 ``mma.sync``
  at f32 accuracy (``csrc/scann_mma.cuh``).
- The global scratch of a launch (``loop_backward_scratch``: the stashes of
  layer inputs and, for SCANN+, 0.9 GB of geometry at the MP2018 batch, and
  the [B * C, P] gradient rows, one per block) can be allocated once per batch
  shape and handed to every launch.

Bounds and designs are in the source notes of the two CUDA files: about
1.85e11 FLOP of FP32 FMA per MP2018 batch (B=64, M=96, N=32, L=9, D=128) for
the forward (~2.8 ms at the H100 SXM's 67 TFLOP/s FP32 peak) and 5.5e11 for
the backward (~8.2 ms); ``loop_backward_flops`` counts what the function
needs, ``loop_recompute_flops`` what the backward's schedule adds.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels.scann_forward import (
    MAX_CHUNK_ROWS,
    MAX_SHARED_BYTES,
    pack_params,
)

REPLACES = "scann_tpu/kernels/scann_loop.py:208"  # _fwd_kernel
SOURCE = "scann_tpu_torch/csrc/scann_loop.cu"
BACKWARD_REPLACES = "scann_tpu/kernels/scann_loop.py:435"  # _bwd_kernel
BACKWARD_SOURCE = "scann_tpu_torch/csrc/scann_loop_backward.cu"
ATOM_BLOCKS = (32, 16, 8)
# Blocks per structure the loop backward launches with -> how many such
# clusters any H100 SXM (132 SMs, 66 pairs of SMs in 8 GPCs) runs at once when
# a block takes most of an SM's shared memory. A cluster of 2 is one pair, so
# 66 always fit; a cluster of 4 needs two pairs of one GPC, so a GPC with an
# odd count of pairs leaves one out: between 29 and 33 fit, depending on the
# die (cudaOccupancyMaxActiveClusters, ``max_active_clusters``, said 30 on
# the card the kernel was measured on; chip_smoke.py prints it).
CLUSTERS_AT_ONCE = {4: 28, 2: 66, 1: 132}
CLUSTER_SIZES = tuple(CLUSTERS_AT_ONCE)


def supports_loop(cfm: ModelConfig) -> bool:
    """Atomic or cgcnn features, with or without ring features, SCANN or
    SCANN+, with or without attention dropout; only ``use_attn_norm=False``
    (no published config) is left to the per-layer model."""
    return cfm.use_attn_norm


def loop_memory_plan(cfm: ModelConfig, M: int, N: int) -> Tuple[int, int, int, int]:
    """(atoms per chunk, atoms per block, floats of the chunk operand buffer,
    shared bytes per block) -- the layout ``make_plan`` in the CUDA source
    walks. The atom block is the largest of 32, 16, 8 whose plan fits a
    block's shared memory (the smallest one's plan if none does)."""
    r4 = lambda x: -(-x // 4) * 4
    D, G, O, H = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.num_head
    wd = max(D, G)
    chunk_atoms = max(1, min(M, MAX_CHUNK_ROWS // max(N, 1)))
    rows = chunk_atoms * N
    stage = r4(cfm.embedding_dim + (10 if cfm.use_ring else 0))
    if cfm.feature == "cgcnn":
        stage += r4(92)
    for block in ATOM_BLOCKS:
        block = min(block, M)
        abuf = max(rows * 2 * D, block * stage)
        floats = (M * wd + 2 * block * wd + abuf + max(rows, block) * D + r4(rows * H)
                  + 2 * wd + 2 * r4(M) + r4(O))
        if 4 * floats <= MAX_SHARED_BYTES:
            break
    return chunk_atoms, block, abuf, 4 * floats


def refusal(cfm: ModelConfig, M: int, N: int,
            inputs: Optional[Dict[str, torch.Tensor]] = None) -> Optional[str]:
    """Why the kernel does not take (config, M, N) or this batch, or None
    where it does: the gate, read by ``check_supported`` and by the dispatch
    in ``Trainer.eval_route``."""
    if inputs is not None and ("segment_onehot" in inputs or "segment_mask" in inputs):
        return ("packed batches (segment_onehot): the per-segment readout of the loop "
                "kernel belongs to structure packing, which is not ported yet")
    if not supports_loop(cfm):
        return ("use_attn_norm=False: the loop kernel always applies ResidualNorm; that "
                "configuration runs in the per-layer model "
                "(models.scann.scann_forward with use_pallas)")
    if M < 1:
        return f"M={M}: no atoms"
    reason = kfwd.common_refusal(cfm, N)
    nbytes = 0 if reason else loop_memory_plan(cfm, M, N)[3]
    if nbytes > MAX_SHARED_BYTES:
        reason = (f"M={M} atoms: the centers plus one atom block need {nbytes} bytes of "
                  f"shared memory, a block has {MAX_SHARED_BYTES}; larger structures go "
                  "through the per-layer kernel (kernels.local_attention)")
    return reason


def check_supported(cfm: ModelConfig, M: int, N: int,
                    inputs: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Raise NotImplementedError for what the kernel does not take."""
    reason = refusal(cfm, M, N, inputs)
    if reason:
        raise NotImplementedError(reason)


def reference_loop_forward(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                           cfm: ModelConfig, mrelu_head: bool = False,
                           dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
                           mol_base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the eager model, called functionally, with the
    kernel's dropout masks at a rate above 0."""
    return kfwd.reference_scann_forward(params, inputs, cfm, mrelu_head, dropout_rate,
                                        dropout_seed or 0, mol_base)


def launch_loop_forward(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                        cfm: ModelConfig, mrelu_head: bool = False,
                        dropout_rate: float = 0.0, seed: int = 0, mol_base: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check CUDA inputs and launch the kernel with ``pack_params`` output."""
    dev = packed["wde"].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    check_supported(cfm, inputs["atomic"].shape[1], inputs["neighbors"].shape[2], inputs)
    kfwd._check_inputs(inputs, cfm, dev)
    return _launch(packed, inputs, cfm, mrelu_head, dropout_rate, seed, mol_base)


launch_loop_forward.launches = 0


def _launch(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
            cfm: ModelConfig, mrelu_head: bool, dropout_rate: float = 0.0,
            seed: int = 0, mol_base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch itself, on inputs ``launch_loop_forward`` accepted."""
    dev = packed["wde"].device
    B, M = inputs["atomic"].shape[:2]
    N = inputs["neighbors"].shape[2]
    chunk_atoms, atom_block, abuf, _ = loop_memory_plan(cfm, M, N)
    tensors, dims, scalars, rng, pred, ga = kfwd.launch_arguments(
        packed, inputs, cfm, mrelu_head, dropout_rate, seed, mol_base, chunk_atoms, abuf)
    next_centers = torch.empty((B, M, cfm.local_dim), device=dev, dtype=torch.float32)
    kfwd.call_kernel("scann_loop", "scann_loop_forward", dev, tensors + [next_centers],
                     dims + [atom_block], scalars, rng)
    launch_loop_forward.launches += 1
    return pred.view(B, 1), ga.view(B, M, 1)


def loop_scann_forward(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                       cfm: ModelConfig, mrelu_head: bool = False,
                       dropout_rate: float = 0.0, dropout_seed: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crystal-scale whole-model forward -> (property [B, 1], ga_score
    [B, M, 1]), f32; the training forward at ``dropout_rate`` > 0 (masks
    keyed on ``dropout_seed``).

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise (unsupported shape or config, bad input, failed build or launch)."""
    dev = inputs["atomic"].device
    M, N = inputs["atomic"].shape[1], inputs["neighbors"].shape[2]
    check_supported(cfm, M, N, inputs)
    if dev.type == "cpu":
        return reference_loop_forward(params, inputs, cfm, mrelu_head, dropout_rate,
                                      dropout_seed)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return launch_loop_forward(pack_params(params, cfm), inputs, cfm, mrelu_head,
                               dropout_rate, dropout_seed or 0)


def loop_forward_flops(cfm: ModelConfig, B: int, M: int, N: int) -> int:
    """Multiply-add FLOPs (2 per FMA) of the forward at one padded batch:
    the products are those of the molecule kernel, so is the count."""
    return kfwd.forward_flops(cfm, B, M, N)


# --- the backward ---------------------------------------------------------------

def loop_backward_memory_plan(cfm: ModelConfig, M: int, N: int) -> Tuple[int, int, int]:
    """(atoms per chunk of rows, atoms per block, shared bytes per block) --
    the layout ``make_plan`` in ``csrc/scann_loop_backward.cu`` walks. The
    atom block is the largest of 32, 16, 8 whose plan fits a block's shared
    memory (the smallest one's plan if none does)."""
    r4 = lambda x: -(-x // 4) * 4
    D, G, O = cfm.local_dim, cfm.global_dim, cfm.dense_out
    wd = max(D, G)
    lde = r4(cfm.embedding_dim + (10 if cfm.use_ring else 0))
    ldf = r4(kbwd.CGCNN_FEATURES) if cfm.feature == "cgcnn" else 0
    for block in ATOM_BLOCKS:
        block = min(block, M)
        chunk_atoms = max(1, min(block, kbwd.MAX_CHUNK_ROWS // max(N, 1)))
        rows = chunk_atoms * N
        work = max(kbwd.chunk_floats(rows, D, cfm.num_head),
                   5 * block * wd + r4(block),
                   block * (2 * lde + ldf) + block * wd,
                   block * wd + 4 * wd + 5 * r4(M) + 3 * r4(O) + 4)   # the readout
        floats = M * wd + 5 * block * wd + work + kbwd.N_WARPS * 2 * wd + 2 * wd
        if 4 * floats <= MAX_SHARED_BYTES:
            break
    return chunk_atoms, block, 4 * floats


def cluster_size(B: int) -> int:
    """Thread blocks per structure of a loop-backward launch at batch size B:
    the largest of 4, 2, 1 with which the batch's clusters still run at once
    on the card (``CLUSTERS_AT_ONCE``). 4 up to 28 structures, 2 up to 66 (the
    MP2018 batch of 64 fills 128 of 132 SMs), 1 beyond."""
    for c, at_once in CLUSTERS_AT_ONCE.items():
        if B <= at_once:
            return c
    return 1


def backward_refusal(cfm: ModelConfig, M: int, N: int,
                     inputs: Optional[Dict[str, torch.Tensor]] = None) -> Optional[str]:
    """Why the loop backward does not take (config, M, N) or this batch, or
    None where it does: the gate, read by ``check_backward_supported`` and by
    the dispatch in ``Trainer.train_route``."""
    if inputs is not None and ("segment_onehot" in inputs or "segment_mask" in inputs):
        return ("packed batches (segment_onehot): the per-segment readout of the loop "
                "kernels belongs to structure packing, which is not ported yet")
    if not supports_loop(cfm):
        return ("use_attn_norm=False: the loop kernels always apply ResidualNorm; that "
                "configuration trains through the per-layer model "
                "(models.scann.scann_forward with use_pallas, under torch.autograd)")
    if M < 1:
        return f"M={M}: no atoms"
    reason = kfwd.common_refusal(cfm, N)
    if reason is None and N > kbwd.MAX_CHUNK_ROWS:
        reason = (f"N={N} neighbours: the loop backward walks chunks of at most "
                  f"{kbwd.MAX_CHUNK_ROWS} (atom, neighbour) rows; wider buckets train "
                  "through the per-layer model")
    nbytes = 0 if reason else loop_backward_memory_plan(cfm, M, N)[2]
    if nbytes > MAX_SHARED_BYTES:
        reason = (f"M={M} atoms: the resident buffer plus one atom block need {nbytes} bytes "
                  f"of shared memory, a block has {MAX_SHARED_BYTES}; larger structures "
                  "train through the per-layer model")
    return reason


def check_backward_supported(cfm: ModelConfig, M: int, N: int,
                             inputs: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Raise NotImplementedError for what the loop backward does not take."""
    reason = backward_refusal(cfm, M, N, inputs)
    if reason:
        raise NotImplementedError(reason)


def reference_loop_grad(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                        cfm: ModelConfig, ct_pred, ct_ga, dropout_rate: float = 0.0,
                        dropout_seed: Optional[int] = None, mol_base: int = 0
                        ) -> Dict[str, torch.Tensor]:
    """The plain version of ``loop_scann_grad``: gradients of sum(pred *
    ct_pred) + sum(ga * ct_ga) through the eager training forward."""
    return kbwd.reference_fused_scann_grad(params, inputs, cfm, ct_pred, ct_ga, dropout_rate,
                                           dropout_seed or 0, mol_base)


def reference_loop_train_grads(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                               targets, cfm: ModelConfig, mrelu_head: bool = False,
                               dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
                               mol_base: int = 0
                               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The plain version of ``loop_scann_train_grads``: (pred [B, 1],
    gradients of 0.5 * sum((pred - t)^2)); mrelu is straight-through."""
    return kbwd.reference_fused_scann_train_grads(params, inputs, targets, cfm, mrelu_head,
                                                  dropout_rate, dropout_seed or 0, mol_base)


def loop_backward_scratch(packed: Dict[str, torch.Tensor], cfm: ModelConfig, B: int, M: int,
                          N: int, cluster: Optional[int] = None
                          ) -> Dict[str, Optional[torch.Tensor]]:
    """The global scratch of one loop-backward launch at batch shape (B, M,
    N): that of the molecule backward with the last centers stashed too and
    one gradient row per block ([B * cluster, P]; ``cluster`` defaults to
    ``cluster_size(B)``), plus the [B, M, D] d(layer output). A trainer
    allocates it once per shape."""
    cluster = cluster_size(B) if cluster is None else cluster
    scratch = kbwd.allocate_scratch(packed, cfm, B, M, N, cfm.n_attention + 1, cluster)
    scratch["dcenters"] = torch.empty((B, M, cfm.local_dim), device=packed["wde"].device,
                                      dtype=torch.float32)
    return scratch


def launch_loop_backward(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                         cfm: ModelConfig, ct: torch.Tensor, ct_ga: Optional[torch.Tensor],
                         one_shot: bool, mrelu_head: bool = False, dropout_rate: float = 0.0,
                         seed: int = 0, mol_base: int = 0,
                         scratch: Optional[Dict[str, Optional[torch.Tensor]]] = None,
                         cluster: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check CUDA inputs and launch the loop backward and its row reduction
    with ``pack_params`` output. ``ct`` [B] is d pred, or the targets when
    ``one_shot``; ``ct_ga`` [B, M] (ignored when ``one_shot``); ``scratch``
    from ``loop_backward_scratch`` at this batch shape and cluster size
    (allocated here when None); ``cluster`` blocks per structure (1, 2 or 4;
    ``cluster_size(B)`` when None). Returns (flat gradients [P], pred [B])."""
    dev = packed["wde"].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    check_backward_supported(cfm, inputs["atomic"].shape[1], inputs["neighbors"].shape[2],
                             inputs)
    kfwd._check_inputs(inputs, cfm, dev)
    return _launch_backward(packed, inputs, cfm, ct, ct_ga, one_shot, mrelu_head, dropout_rate,
                            seed, mol_base, scratch, cluster)


launch_loop_backward.launches = 0


def _launch_backward(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                     cfm: ModelConfig, ct: torch.Tensor, ct_ga: Optional[torch.Tensor],
                     one_shot: bool, mrelu_head: bool = False, dropout_rate: float = 0.0,
                     seed: int = 0, mol_base: int = 0,
                     scratch: Optional[Dict[str, Optional[torch.Tensor]]] = None,
                     cluster: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch itself, on inputs ``launch_loop_backward`` accepted."""
    B, M = inputs["atomic"].shape[:2]
    N = inputs["neighbors"].shape[2]
    chunk_atoms, atom_block, _ = loop_backward_memory_plan(cfm, M, N)
    cluster = cluster_size(B) if cluster is None else cluster
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster={cluster}: the loop backward launches with {CLUSTER_SIZES}")
    if scratch is None:
        scratch = loop_backward_scratch(packed, cfm, B, M, N, cluster)
    elif (scratch["dcenters"].shape != (B, M, cfm.local_dim)
          or scratch["rows"].shape[0] != B * cluster):
        raise ValueError(f"scratch of shape {tuple(scratch['dcenters'].shape)} with "
                         f"{scratch['rows'].shape[0]} gradient rows handed to a batch of shape "
                         f"{(B, M, cfm.local_dim)} at {cluster} blocks per structure")
    tensors, dims, scalars, rng, offsets, flat, pred = kbwd.launch_arguments(
        packed, inputs, cfm, ct, ct_ga, one_shot, mrelu_head, dropout_rate, seed, mol_base,
        chunk_atoms, scratch)
    kfwd.call_kernel("scann_loop_backward", "scann_loop_backward", packed["wde"].device,
                     tensors + [scratch["dcenters"]], dims + [atom_block, cluster], scalars,
                     rng, offsets, flat)
    launch_loop_backward.launches += 1
    return flat, pred


def max_active_clusters(cfm: ModelConfig, B: int, M: int, N: int, cluster: int) -> int:
    """How many clusters of ``cluster`` loop-backward blocks at this shape the
    card runs at once (``cudaOccupancyMaxActiveClusters``); a launch of more
    than that many structures takes more than one wave."""
    import ctypes

    from scann_tpu_torch.kernels._build import load_library

    chunk_atoms, atom_block, _ = loop_backward_memory_plan(cfm, M, N)
    dims = [B, M, N, cfm.local_dim, cfm.num_head, cfm.embedding_dim, cfm.num_gaussian,
            cfm.global_dim, cfm.dense_out, cfm.n_attention, kbwd.CGCNN_FEATURES, 0,
            int(cfm.feature == "cgcnn"), int(cfm.use_ring), 0, 0, 0, 0, chunk_atoms, 0, 0,
            atom_block]
    fn = load_library("scann_loop_backward").scann_loop_backward_max_clusters
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn((ctypes.c_int * len(dims))(*dims), cluster)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with CUDA error {-n}")
    return n


def loop_scann_grad(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                    cfm: ModelConfig, ct_pred, ct_ga, dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Parameter gradients of (pred, ga) contracted with (ct_pred [B] or
    [B, 1], ct_ga [B, M] or [B, M, 1]) through the loop backward kernel."""
    dev = inputs["atomic"].device
    check_backward_supported(cfm, inputs["atomic"].shape[1], inputs["neighbors"].shape[2],
                             inputs)
    if dev.type == "cpu":
        return reference_loop_grad(params, inputs, cfm, ct_pred, ct_ga, dropout_rate,
                                   dropout_seed)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    packed = pack_params(params, cfm)
    flat, _ = launch_loop_backward(packed, inputs, cfm, torch.as_tensor(ct_pred, device=dev),
                                   torch.as_tensor(ct_ga, device=dev), False, False,
                                   dropout_rate, dropout_seed or 0)
    return kbwd.grads_from_flat(flat, packed, cfm)


def loop_scann_train_grads(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                           targets, cfm: ModelConfig, mrelu_head: bool = False,
                           dropout_rate: float = 0.0, dropout_seed: Optional[int] = None
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-shot crystal training: forward, residual and backward in one
    launch. Returns (pred [B, 1], raw gradients of 0.5 * sum((pred - t)^2));
    the caller turns them into RMSE + l2 gradients (``train.loop``)."""
    dev = inputs["atomic"].device
    check_backward_supported(cfm, inputs["atomic"].shape[1], inputs["neighbors"].shape[2],
                             inputs)
    if dev.type == "cpu":
        return reference_loop_train_grads(params, inputs, targets, cfm, mrelu_head,
                                          dropout_rate, dropout_seed)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    packed = pack_params(params, cfm)
    flat, pred = launch_loop_backward(packed, inputs, cfm, torch.as_tensor(targets, device=dev),
                                      None, True, mrelu_head, dropout_rate, dropout_seed or 0)
    return pred.view(-1, 1), kbwd.grads_from_flat(flat, packed, cfm)


class _LoopScannApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, inputs, *values):
        keys, cfm, mrelu_head, dropout_rate, seed = spec
        pred, ga = loop_scann_forward(dict(zip(keys, values)), inputs, cfm, mrelu_head,
                                      dropout_rate, seed)
        ctx.spec, ctx.inputs = spec, inputs
        ctx.save_for_backward(*values)
        return pred, ga

    @staticmethod
    def backward(ctx, d_pred, d_ga):
        keys, cfm, _, dropout_rate, seed = ctx.spec
        params = dict(zip(keys, ctx.saved_tensors))
        B, M = ctx.inputs["atomic"].shape[:2]
        dev = ctx.saved_tensors[0].device
        ct_pred = d_pred if d_pred is not None else torch.zeros(B, 1, device=dev)
        ct_ga = d_ga if d_ga is not None else torch.zeros(B, M, 1, device=dev)
        # mrelu head: straight-through, so the cotangent passes unchanged
        grads = loop_scann_grad(params, ctx.inputs, cfm, ct_pred, ct_ga, dropout_rate, seed)
        return (None, None, *[grads[k] for k in keys])


def loop_scann_apply(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                     cfm: ModelConfig, mrelu_head: bool = False, dropout_rate: float = 0.0,
                     dropout_seed: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable crystal-scale forward -> (pred [B, 1], ga [B, M, 1]):
    ``torch.autograd`` through it runs the loop backward kernel (parameter
    gradients only), on the dropout masks of the forward."""
    keys = tuple(params)
    spec = (keys, cfm, mrelu_head, dropout_rate, dropout_seed or 0)
    return _LoopScannApply.apply(spec, inputs, *[params[k] for k in keys])


def loop_backward_flops(cfm: ModelConfig, B: int, M: int, N: int) -> int:
    """Multiply-add FLOPs (2 per FMA) that the function needs at one padded
    batch, whatever the schedule: the products are those of the molecule
    backward, so is the count. The kernel's bound is computed from it."""
    return kbwd.backward_flops(cfm, B, M, N)


def loop_recompute_flops(cfm: ModelConfig, B: int, M: int, N: int) -> int:
    """FLOPs that the loop backward's schedule adds to ``loop_backward_flops``
    at one padded batch: in the reverse walk each layer's ResidualNorm, query
    (and cw), (atom, neighbour) rows and energies again (the context is
    stashed); in the readout's second pass after_Lc and the GA queries; the
    embedding and the SCANN+ geometry embedding. Elementwise work, softmax
    and LayerNorm are left out, as in ``forward_flops``."""
    D, K, E, G = cfm.local_dim, cfm.num_gaussian, cfm.embedding_dim, cfm.global_dim
    R = M * N
    mm = lambda rows, k, n: 2 * rows * k * n
    f = mm(M, D, G) + mm(M, G, G)                                  # readout, second pass
    per_layer = 2 * mm(M, D, D)                                    # ResidualNorm
    per_layer += (2 if cfm.g_update else 1) * mm(M, D, D)          # query (and cw)
    per_layer += (mm(R, 2 * D, D) if cfm.g_update else mm(R, K, D)) + mm(R, D, D)  # rows
    per_layer += 2 * R * D                                         # energies
    f += cfm.n_attention * per_layer
    f += mm(M, E + (10 if cfm.use_ring else 0), D)                 # embedding
    if cfm.feature == "cgcnn":
        f += mm(M, kbwd.CGCNN_FEATURES, E)
    if cfm.g_update:
        f += 2 * mm(R, K, D)                                       # geometry embedding
    return B * f
