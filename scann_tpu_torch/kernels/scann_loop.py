"""Whole-model SCANN forward for crystals on the GPU: the wrapper around
``csrc/scann_loop.cu``.

Replaces ``scann_tpu/kernels/scann_loop.py:_fwd_kernel`` (the Pallas TPU
kernel that runs the whole model with a ``fori_loop`` over its layers) for
unpacked batches whose structures are too large for the molecule kernel of
``kernels.scann_forward``: MP2018 at (M=96, N=32, 9 layers), Pt/graphene at
(M=128, N=32, 11 layers, ring features). The backward half of the TPU module
(``_bwd_kernel``) is not ported yet, so crystals are served, not trained.

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

Bound and design are in the source note of ``csrc/scann_loop.cu``: about
1.85e11 FLOP of FP32 FMA per MP2018 batch (B=64, M=96, N=32, L=9, D=128), so
it is bound by operations (~2.8 ms at the H100 SXM's 67 TFLOP/s FP32 peak).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels.scann_forward import (
    MAX_CHUNK_ROWS,
    MAX_SHARED_BYTES,
    pack_params,
)

REPLACES = "scann_tpu/kernels/scann_loop.py:208"  # _fwd_kernel
SOURCE = "scann_tpu_torch/csrc/scann_loop.cu"
ATOM_BLOCKS = (32, 16, 8)


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
