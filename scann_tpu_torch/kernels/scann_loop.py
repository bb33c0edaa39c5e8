"""Whole-model SCANN forward and backward for crystals on the GPU: the
wrappers around ``csrc/scann_loop.cu`` and ``csrc/scann_loop_backward.cu``.

Replaces ``scann_tpu/kernels/scann_loop.py`` (the Pallas TPU kernels that run
the whole model with a ``fori_loop`` over its layers: ``_fwd_kernel`` and
``_bwd_kernel``) for batches whose structures are too large for the
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
  kernel launches (``.bf16_launches`` those in the bf16 operand mode).
- ``model.dtype: "bfloat16"``: the bf16 operand mode of ``kernels/dots.py``
  (``kernels.scann_forward`` says what it rounds); the plain version is
  ``kfwd.reference_bf16_forward`` with the TPU loop kernel's bf16-mode
  segment pools (``scann_loop.py:367-395``: pooled terms and values rounded,
  each segment's own max as the softmax shift), which the CUDA kernel
  follows.
- The gate (``check_supported``) is the kernel's own shared-memory plan
  (``loop_memory_plan``). On the TPU the two whole-model kernels differ in
  compile time (unrolled layers against a loop); here both loop at run time
  and differ in where a structure's state lives. This kernel keeps only the
  current centers [M, max(D, G)] in shared memory for a whole layer and every
  other per-atom tensor for one block of 32, 16 or 8 atoms at a time, so it
  needs M * 512 bytes + 108 to 133 KB at D = G = 128: M <= 237 (at N = 32)
  fits a block's 227 KB. It shares the molecule kernel's tiles: chunks
  of at most 64 (atom, neighbour) rows, D, G, O multiples of 4 up to 128.
  ``use_attn_norm=False`` is refused.
- Tall structures, N <= 64 and M past that plan: the tall build
  ``csrc/scann_loop_tall.cu`` (built at its first launch, both operand
  modes) keeps the centers in global memory, which L2 holds: a ping-pong [2, B,
  M, D] (``loop_forward_scratch``'s ``next_centers``) and each block's GA
  keys (its ``tall``, [B * C, M, G]). Its plan drops the M * 512 bytes, so
  atom blocks of 32 take M into the thousands, past every M the TPU kernel
  takes. Its arithmetic and sums are the narrow build's: at a shape both
  take (the private ``_launch(..., tall=True)`` forces it there, with the
  narrow atom blocks) the outputs are the same bits, in either operand mode.
  ``is_tall`` is its rule, ``forward_library`` names the build of every
  launch, and ``.tall_launches`` counts these launches.
- Wide neighbour lists, 64 < N <= 256 (``MAX_NEIGHBORS``): the wide build
  ``csrc/scann_loop_wide.cu`` (built at its first launch, both operand
  modes): one atom at a time, its rows in sub-chunks of 64, the softmax
  over all N from its energy row in shared memory, its keys in a per-block
  scratch (``loop_forward_scratch``'s ``wide_keys``, [B * C, N, D]).
  ``.wide_launches`` counts these launches.
- The gates do not depend on the operand mode, as ``fits_loop_vmem`` on
  the TPU does not: a ``model.dtype: bfloat16`` batch takes the build an
  f32 batch of its shape takes, and every build holds the bf16
  instantiation beside the f32 one (``.bf16_launches`` counts bf16 launches
  in every build, beside ``.wide_launches`` and ``.tall_launches``).
- Packed batches (``segment_onehot`` [B, M, S], structure packing) run the
  GA readout per segment in both kernels (``segment_ids`` and S, as
  ``kernels.scann_forward`` says): pred, the cotangent and the targets are
  [B, S], and the plans grow by the per-segment vectors (``max_segments``,
  ``backward_max_segments``). The softmax is shifted by the slot's max, as
  the molecule kernels and the JAX model shift it; the TPU loop kernels
  shift by each segment's max, which differs only where a segment's sum
  underflows to 0 (no published config: ``use_ga_norm`` bounds the scores).
- Like the backward, it launches a cluster of ``cluster_size(B)`` blocks per
  structure (``launch_loop_forward(..., cluster=C)`` takes another C), each
  block on a contiguous share of the atoms; the new centers of a layer cross
  the cluster through a global [B, M, D] scratch. Its products run as
  split-TF32 ``mma.sync`` (``csrc/scann_forward_common.cuh``). Launches at one
  C repeat bit for bit, also on a kept scratch (``loop_forward_scratch``)
  that holds garbage.

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
  backward kernel plus its row reduction; ``.bf16_launches`` those in the
  bf16 operand mode) or raise; CPU tensors run the plain versions
  ``reference_loop_grad`` / ``reference_loop_train_grads``: the training
  forward under ``torch.autograd``, the code of
  ``kernels.scann_backward.reference_fused_scann_*``.
- ``model.dtype: "bfloat16"`` trains in the bf16 operand mode, as
  ``scann_loop.py:1096`` does: ``csrc/scann_loop_backward_bf16.cu`` (the same
  source built for that mode) rounds where kernel #2 does and pools packed
  segments as bf16-mode products with each segment's own max, as kernel #3
  does; its plain version is ``kfwd.reference_bf16_forward`` with those
  pools under ``torch.autograd``. The wide and tall builds have their bf16
  builds too (``scann_loop_backward_wide_bf16.cu``,
  ``scann_loop_backward_tall_bf16.cu``), so the mode trains on a kernel at
  every shape an f32 model does (``backward_library`` names the build).
- Its gate (``backward_refusal``) is again the kernel's own plan
  (``loop_backward_memory_plan``): one resident [M, max(D, G)] buffer (the
  centers going forward, the accumulating d(layer input) going back), five
  slots for a block of 32, 16 or 8 atoms, and a work region for a chunk of at
  most 32 (atom, neighbour) rows, so, at D = G = 128 and N = 32, M <= 106
  with blocks of 32, M <= 186 with blocks of 16 and M <= 226 with blocks of
  8: lower than the forward's 232. Beyond it, at N <= 32, the tall build
  ``csrc/scann_loop_backward_tall.cu`` (all three schedules;
  ``is_tall_backward``, ``.tall_launches``) gives the resident buffer's
  three roles global homes: the forward pass gathers from the layer-input
  stash, the GA keys and each block's d(layer input) partial go to the
  ``tall`` scratch [B * C, M, G + D], and the cluster sums the partials in
  rank order as the narrow build sums them through distributed shared
  memory, so both builds give the same bits at a shape both take
  (``_launch_backward(..., tall=True)``). What no build takes trains through
  the per-layer model under ``torch.autograd`` (``Trainer.train_route``).
- Wide neighbour lists, 32 < N <= 256: the wide build
  ``csrc/scann_loop_backward_wide.cu`` (all three schedules;
  ``.wide_launches``), one atom at a time in sub-chunks of 32
  rows beside the atom's attention and d attention [N, H], with atom blocks
  down to 4 (``WIDE_BACKWARD_ATOM_BLOCKS``): M up to 217-243 at D = 128.
  Its reverse walk runs the softmax backward over all N before the rows'
  backward, so the recompute schedule forms each row twice there.
- A cluster of C thread blocks works on each structure, each block on its
  share of the atoms (``cluster_size``: C is a function of the batch size
  alone, 2 at the MP2018 batch of 64, so that the batch fills the card's 132
  SMs in one wave). Launches at one C repeat bit for bit; two values of C
  differ in the last bits, each within the same tolerance of the plain
  version. The products run on the tensor cores as split-TF32 ``mma.sync``
  at f32 accuracy (``csrc/scann_mma.cuh``).
- The global scratch of a launch (``loop_backward_scratch``: the stashes of
  layer inputs and, for SCANN+, 0.9 GB of geometry at the MP2018 batch, the
  [B * C, P] gradient rows, one per block, and the selective stash) can be
  allocated once per batch shape and handed to every launch.
- Schedule (the TPU kernel's ``loop_stash_mode``, ``scann_loop.py:165-183``):
  by default the selective activation stash, wherever ``loop_stash_mode``
  admits it: the forward pass writes each layer's neighbour states, u_pre,
  keys [B, L, M*N, D] and attention [B, L, M*N, H] (2.77 GB at the MP2018
  batch, ``loop_stash_bytes``), and the reverse walk reads them back in
  place of the gather, the u_pre and key products and the softmax, and
  rebuilds the rest as ``acts_from_stash`` does. "Fits" is the card's rule:
  the stash against ``kbwd.STASH_BUDGET_BYTES`` (6 GiB a launch, a
  constant), which every published shape's f32 stash meets.
  ``SCANN_TPU_LOOP_STASH=0`` runs the recompute schedule;
  ``SCANN_TPU_LOOP_STASH_BF16=1`` takes the bf16 stash (the four row
  buffers rounded, o1 kept in f32) only where the f32 stash does not fit and
  the halved one does. The f32 stash is bit for bit the recompute
  schedule's gradient; the bf16 stash's plain version is
  ``reference_loop_stash_*`` (``loop_rebuild``: ``acts_from_stash``).
  ``launch_loop_backward.stash_launches`` / ``.bf16_stash_launches`` count
  launches by schedule.

Bounds and designs are in the source notes of the two CUDA files: about
1.85e11 FLOP per MP2018 batch (B=64, M=96, N=32, L=9, D=128) for the forward
(~1.13 ms as three TF32 passes per product at the H100 SXM's dense 495
TFLOP/s, the energies and context at 67 TFLOP/s FP32; its 100 MB geometry
scratch does not fit the 50 MB L2 and crosses HBM twice a layer, ~0.55 ms,
which ``loop_forward_bytes`` counts) and 5.5e11 for the backward (~3.37 ms);
``loop_backward_flops`` counts what the function needs,
``loop_recompute_flops`` what the backward's schedule adds.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.kernels import dots
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels.local_attention import is_wide
from scann_tpu_torch.kernels.scann_forward import (
    MAX_CHUNK_ROWS,
    MAX_NEIGHBORS,
    MAX_SHARED_BYTES,
    largest_segments,
    pack_params,
    seg_backward_floats,
    seg_forward_floats,
    segment_arguments,
    segment_count,
    segment_refusal,
)
from scann_tpu_torch.models.scann import check_index_ranges
from scann_tpu_torch.ops.activations import swish

REPLACES = "scann_tpu/kernels/scann_loop.py:208"  # _fwd_kernel
SOURCE = "scann_tpu_torch/csrc/scann_loop.cu"
BACKWARD_REPLACES = "scann_tpu/kernels/scann_loop.py:435"  # _bwd_kernel
BACKWARD_SOURCE = "scann_tpu_torch/csrc/scann_loop_backward.cu"
ATOM_BLOCKS = (32, 16, 8)
# the wide loop backward (N > kbwd.MAX_CHUNK_ROWS) also takes blocks of 4
# atoms, where 8 do not fit beside its atom-wide attention rows
WIDE_BACKWARD_ATOM_BLOCKS = ATOM_BLOCKS + (4,)
# the tall loop backward's chunk of (atom, neighbour) rows (kTallChunkRows of
# csrc/scann_loop_backward.cu): two atoms at N = 32, in the shared memory the
# resident buffer left; the narrow and wide builds keep kbwd.MAX_CHUNK_ROWS
TALL_CHUNK_ROWS = 64
# Blocks per structure the loop kernels (forward and backward) launch with ->
# how many such clusters any H100 SXM (132 SMs, 66 pairs of SMs in 8 GPCs)
# runs at once when a block takes a whole SM (most of its shared memory, or
# 255 registers a thread). A cluster of 2 is one pair, so
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


def loop_memory_plan(cfm: ModelConfig, M: int, N: int, S: int = 0, tall: bool = False
                     ) -> Tuple[int, int, int, int]:
    """(atoms per chunk, atoms per block, floats of the work region, shared
    bytes per block) -- the layout ``make_plan`` in the CUDA source walks:
    the centers [M, max(D, G)] (none in the tall build, ``tall``), two
    slots [block, max(D, G) + 4], and a work
    region that holds a chunk's buffers (wide, N > 64: a sub-chunk's and the
    atom's energies [N, H], one atom a chunk), the embedding's staging, the
    ResidualNorm's h2 or the readout's block and vectors (per segment for a
    packed batch of S segments a slot). The atom block is the largest of 32,
    16, 8 whose plan fits a block's shared memory (the smallest one's plan
    if none does). ``forward_plan`` is the plan of the build a launch takes."""
    r4 = lambda x: -(-x // 4) * 4
    D, G, O, H = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.num_head
    wd = max(D, G)
    wide = is_wide(N)
    for block in ATOM_BLOCKS:
        block = min(block, M)
        chunk_atoms = max(1, min(block, MAX_CHUNK_ROWS // max(N, 1)))
        chunk = (kfwd.forward_wide_chunk_floats(N, D, H) if wide
                 else kfwd.forward_chunk_floats(chunk_atoms * N, D, H))
        work = max(chunk,
                   kfwd.embedding_stage_floats(cfm, block), block * (wd + 4),
                   block * wd + 2 * wd + 2 * r4(M) + r4(O))
        if S:
            work = max(work, block * wd + seg_forward_floats(S, wd, M, O))
        floats = (0 if tall else M * wd) + 2 * block * (wd + 4) + work
        if 4 * floats <= MAX_SHARED_BYTES:
            break
    return chunk_atoms, block, work, 4 * floats


def is_tall(cfm: ModelConfig, M: int, N: int, S: int = 0) -> bool:
    """Whether the loop forward takes (config, M, N, S) in its tall build
    (``csrc/scann_loop_tall.cu``): a narrow N (not ``is_wide``) whose narrow
    plan does not fit a block's shared memory, so the centers live in global
    memory."""
    return not is_wide(N) and loop_memory_plan(cfm, M, N, S)[3] > MAX_SHARED_BYTES


def forward_plan(cfm: ModelConfig, M: int, N: int, S: int = 0) -> Tuple[int, int, int, int]:
    """``loop_memory_plan`` of the build the gate picks for (config, M, N, S):
    the narrow (or wide) plan where it fits, else the tall one. A launch
    forced into the tall build (``tall=True``) keeps this plan, so it runs
    the narrow build's atom blocks."""
    return loop_memory_plan(cfm, M, N, S, is_tall(cfm, M, N, S))


def is_wide_backward(N: int) -> bool:
    """Whether the loop backward takes N neighbours in its wide build
    (``csrc/scann_loop_backward_wide.cu``)."""
    return N > kbwd.MAX_CHUNK_ROWS


def forward_library(cfm: ModelConfig, M: int, N: int, S: int = 0, tall: bool = False
                    ) -> Tuple[str, str]:
    """(library, entry-point prefix) of the loop forward's build that takes
    (config, M, N, S): the wide one (``csrc/scann_loop_wide.cu``) where
    ``is_wide``, the tall one (``csrc/scann_loop_tall.cu``) where ``is_tall``
    or ``tall`` forces it, else the narrow one. Each build holds both
    operand modes (``kfwd.operand_mode(cfm)`` is a launch argument), so the
    library is the same for f32 and bf16. The one place that chooses."""
    if is_wide(N):
        return "scann_loop_wide", "scann_loop_forward_wide"
    if tall or is_tall(cfm, M, N, S):
        return "scann_loop_tall", "scann_loop_forward_tall"
    return "scann_loop", "scann_loop_forward"


def backward_library(cfm: ModelConfig, M: int, N: int, S: int = 0, tall: bool = False) -> str:
    """The loop backward's build that takes (config, M, N, S), the name of
    its library and its entry points: the wide one where
    ``is_wide_backward``, the tall one where ``is_tall_backward`` or
    ``tall`` forces it, else the narrow one; each in the config's operand
    mode (``kbwd.kernel_name``: ``<build>_bf16`` in bf16, a source of its
    own). The one place that chooses."""
    if is_wide_backward(N):
        return kbwd.kernel_name("scann_loop_backward_wide", cfm)
    if tall or is_tall_backward(cfm, M, N, S):
        return kbwd.kernel_name("scann_loop_backward_tall", cfm)
    return kbwd.kernel_name("scann_loop_backward", cfm)


def max_segments(cfm: ModelConfig, M: int, N: int) -> int:
    """The largest S a packed batch of shape (M, N) may have in the loop
    forward (in the build each S takes)."""
    return largest_segments(lambda S: forward_plan(cfm, M, N, S)[3])


def refusal(cfm: ModelConfig, M: int, N: int, S: int = 0) -> Optional[str]:
    """Why the kernel does not take (config, M, N) at S segments a slot (0:
    unpacked), or None where it does: the gate, read by ``check_supported``
    and by the dispatch in ``Trainer.eval_route``."""
    if not supports_loop(cfm):
        return ("use_attn_norm=False: the loop kernel always applies ResidualNorm; that "
                "configuration runs in the per-layer model "
                "(models.scann.scann_forward with use_pallas)")
    if M < 1:
        return f"M={M}: no atoms"
    reason = kfwd.common_refusal(cfm, N, MAX_NEIGHBORS) or segment_refusal(S)
    if reason:
        return reason
    tall = is_tall(cfm, M, N, S)
    nbytes = forward_plan(cfm, M, N, S)[3]
    if nbytes > MAX_SHARED_BYTES:
        reason = (f"M={M} atoms" + (f", S={S} segments" if S else "") + ": "
                  + ("one atom block and the readout's vectors" if tall
                     else "the centers plus one atom block") + f" need {nbytes} bytes of "
                  f"shared memory, a block has {MAX_SHARED_BYTES}; larger structures go "
                  "through the per-layer kernel (kernels.local_attention)")
    return reason


def check_supported(cfm: ModelConfig, M: int, N: int, S: int = 0) -> None:
    """Raise NotImplementedError for what the kernel does not take."""
    reason = refusal(cfm, M, N, S)
    if reason:
        raise NotImplementedError(reason)


def reference_loop_forward(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                           cfm: ModelConfig, mrelu_head: bool = False,
                           dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
                           mol_base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the eager model, called functionally, with the
    kernel's dropout masks at a rate above 0; in the bf16 operand mode
    ``kfwd.reference_bf16_forward`` with the loop kernel's segment pools."""
    if cfm.dtype == "bfloat16":
        return kfwd.reference_bf16_forward(
            params, inputs, cfm, mrelu_head, False,
            kfwd.dropout_masks_for(cfm, inputs, dropout_rate, dropout_seed or 0, mol_base))
    return kfwd.reference_scann_forward(params, inputs, cfm, mrelu_head, dropout_rate,
                                        dropout_seed or 0, mol_base)


def loop_forward_scratch(cfm: ModelConfig, B: int, M: int, N: int, device,
                         cluster: Optional[int] = None, S: int = 0,
                         tall: Optional[bool] = None) -> Dict[str, Optional[torch.Tensor]]:
    """The global scratch of one loop-forward launch at batch shape (B, M,
    N), S segments a slot and ``cluster`` blocks per structure
    (``cluster_size(B)`` when None): the SCANN+ geometry [B * M * N * D]
    (None for SCANN), the new centers [B, M, D] (the tall build's ping-pong
    centers [2, B, M, D]), for a wide N each block's keys of one atom [B * C,
    N, D] (else None) and for the tall build each block's GA keys ``tall``
    [B * C, M, G] (else None). ``tall`` defaults to ``is_tall``; True is the
    scratch of a launch forced into the tall build. Its contents mean
    nothing between launches; a launch allocates its own unless it is handed
    one, and refuses one of another build."""
    D = cfm.local_dim
    cluster = cluster_size(B) if cluster is None else cluster
    tall = is_tall(cfm, M, N, S) if tall is None else tall
    empty = lambda *shape: torch.empty(shape, device=device, dtype=torch.float32)
    shape = wide_keys_shape_for(cfm, B, N, cluster)
    return {"geo": empty(B * M * N * D) if cfm.g_update else None,
            "next_centers": empty(2, B, M, D) if tall else empty(B, M, D),
            "wide_keys": None if shape is None else empty(*shape),
            "tall": empty(*tall_shape_for(cfm, B, M, cluster, True)) if tall else None}


def wide_keys_shape_for(cfm: ModelConfig, B: int, N: int, cluster: int,
                        wide: Optional[bool] = None) -> Optional[Tuple[int, int, int]]:
    """The wide builds' key scratch [B * C, N, D] (one atom's keys a block),
    None where N is not wide (``wide`` defaults to the forward's rule)."""
    wide = is_wide(N) if wide is None else wide
    return (B * cluster, N, cfm.local_dim) if wide else None


def wide_keys_shape(t: Optional[torch.Tensor]) -> Optional[Tuple[int, ...]]:
    """The shape of a kept scratch's key scratch (None where it has none)."""
    return None if t is None else tuple(t.shape)


def tall_shape_for(cfm: ModelConfig, B: int, M: int, cluster: int, tall: bool,
                   backward: bool = False) -> Optional[Tuple[int, int, int]]:
    """The tall builds' scratch: each block's GA keys [B * C, M, G] in the
    forward, its GA keys and d(layer input) partial [B * C, M, G + D] in the
    backward; None for the other builds."""
    if not tall:
        return None
    return (B * cluster, M, cfm.global_dim + (cfm.local_dim if backward else 0))


def launch_loop_forward(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                        cfm: ModelConfig, mrelu_head: bool = False,
                        dropout_rate: float = 0.0, seed: int = 0, mol_base: int = 0,
                        cluster: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check CUDA inputs and launch the kernel with ``pack_params`` output,
    at ``cluster`` blocks per structure (``cluster_size(B)`` when None), in
    the build ``forward_library`` names. Index ranges are the caller's, as
    ``kernels.scann_forward.launch_scann_forward`` says."""
    dev = packed["wde"].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    check_supported(cfm, inputs["atomic"].shape[1], inputs["neighbors"].shape[2],
                    segment_count(inputs))
    kfwd._check_shapes(inputs, cfm, dev)
    return _launch(packed, inputs, cfm, mrelu_head, dropout_rate, seed, mol_base, cluster)


launch_loop_forward.launches = 0
launch_loop_forward.bf16_launches = 0
launch_loop_forward.wide_launches = 0
launch_loop_forward.tall_launches = 0


def _launch(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
            cfm: ModelConfig, mrelu_head: bool, dropout_rate: float = 0.0,
            seed: int = 0, mol_base: int = 0, cluster: Optional[int] = None,
            scratch: Optional[Dict[str, Optional[torch.Tensor]]] = None, tall: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch itself, on inputs ``launch_loop_forward`` accepted, at
    ``cluster`` blocks per structure (``cluster_size(B)`` when None), on
    ``scratch`` from ``loop_forward_scratch`` (allocated here when None; one
    of another build raises), in the tall build where ``is_tall`` or
    ``tall`` (True forces it at a shape the narrow build takes, with the
    narrow plan's atom blocks, for the checks that hold the two builds bit
    for bit)."""
    dev = packed["wde"].device
    B, M = inputs["atomic"].shape[:2]
    N = inputs["neighbors"].shape[2]
    seg, S = segment_arguments(inputs)
    cluster = cluster_size(B) if cluster is None else cluster
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster={cluster}: the loop forward launches with {CLUSTER_SIZES}")
    library, symbol = forward_library(cfm, M, N, S, tall)
    tall = library == "scann_loop_tall"
    want = loop_forward_scratch(cfm, B, M, N, "meta", cluster, S, tall)
    if scratch is None:
        scratch = loop_forward_scratch(cfm, B, M, N, dev, cluster, S, tall)
    elif any(wide_keys_shape(scratch.get(k)) != wide_keys_shape(want[k])
             for k in ("next_centers", "wide_keys", "tall")):
        raise ValueError(f"scratch of shape {wide_keys_shape(scratch['next_centers'])} (wide "
                         f"keys {wide_keys_shape(scratch['wide_keys'])}, tall "
                         f"{wide_keys_shape(scratch.get('tall'))}) handed to a batch of shape "
                         f"{(B, M, cfm.local_dim)} at {cluster} blocks per structure in the "
                         f"{library} build")
    bf16 = kfwd.operand_mode(cfm)
    chunk_atoms, atom_block, work, _ = forward_plan(cfm, M, N, S)
    tensors, dims, scalars, rng, pred, ga = kfwd.launch_arguments(
        packed, inputs, cfm, mrelu_head, dropout_rate, seed, mol_base, chunk_atoms, work,
        scratch["geo"])
    wide = is_wide(N)
    kfwd.call_kernel(library, symbol, dev,
                     tensors + [scratch["next_centers"], seg,
                                scratch["tall"] if tall else scratch["wide_keys"]],
                     dims + [atom_block, S, bf16, cluster], scalars, rng)
    launch_loop_forward.launches += 1
    launch_loop_forward.bf16_launches += bf16
    launch_loop_forward.wide_launches += wide
    launch_loop_forward.tall_launches += tall
    return pred.view(B, max(S, 1)), ga.view(B, M, 1)


def loop_scann_forward(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                       cfm: ModelConfig, mrelu_head: bool = False,
                       dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
                       mol_base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crystal-scale whole-model forward -> (property [B, 1], ga_score
    [B, M, 1]), f32; the training forward at ``dropout_rate`` > 0 (masks
    keyed on ``dropout_seed``). A packed batch gives the property [B, S].

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise (unsupported shape or config, bad input, failed build or launch)."""
    dev = inputs["atomic"].device
    M, N = inputs["atomic"].shape[1], inputs["neighbors"].shape[2]
    check_supported(cfm, M, N, segment_count(inputs))
    if dev.type == "cpu":
        return reference_loop_forward(params, inputs, cfm, mrelu_head, dropout_rate,
                                      dropout_seed, mol_base)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_index_ranges(inputs, cfm)
    return launch_loop_forward(pack_params(params, cfm), inputs, cfm, mrelu_head,
                               dropout_rate, dropout_seed or 0, mol_base)


def loop_forward_flops(cfm: ModelConfig, B: int, M: int, N: int) -> int:
    """Multiply-add FLOPs (2 per product term) of the forward at one padded
    batch: the products are those of the molecule kernel, so is the count."""
    return kfwd.forward_flops(cfm, B, M, N)


def loop_forward_bytes(cfm: ModelConfig, B: int, M: int, N: int) -> int:
    """Bytes of HBM traffic the forward needs at one padded batch beyond one
    read of its inputs and weights and one write of its outputs: the SCANN+
    geometry [B, M * N, D] f32 (100 MB at the MP2018 batch) does not fit the
    card's 50 MB of L2 beside the rest, so the embedding writes it once and
    each of the L layers reads it and all but the last write it back (2 L
    passes). SCANN keeps no geometry scratch: 0."""
    if not cfm.g_update:
        return 0
    return 2 * cfm.n_attention * B * M * N * cfm.local_dim * 4


def max_active_forward_clusters(cfm: ModelConfig, B: int, M: int, N: int, cluster: int) -> int:
    """How many clusters of ``cluster`` loop-forward blocks at this shape the
    card runs at once (``cudaOccupancyMaxActiveClusters``), in the kernel of
    the build and operand mode that launches (M, N) (``forward_library``,
    ``kfwd.operand_mode``)."""
    import ctypes

    from scann_tpu_torch.kernels._build import load_library

    chunk_atoms, atom_block, work, _ = forward_plan(cfm, M, N)
    dims = [B, M, N, cfm.local_dim, cfm.num_head, cfm.embedding_dim, cfm.num_gaussian,
            cfm.global_dim, cfm.dense_out, cfm.n_attention, kfwd.CGCNN_FEATURES,
            int(cfm.feature == "cgcnn"), int(cfm.use_ring), int(cfm.g_update), 0, 0,
            chunk_atoms, work, 0, 0, atom_block, 0, kfwd.operand_mode(cfm), cluster]
    library, symbol = forward_library(cfm, M, N)
    fn = getattr(load_library(library), symbol + "_max_clusters")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn((ctypes.c_int * len(dims))(*dims), cluster)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with CUDA error {-n}")
    return n


# --- the backward ---------------------------------------------------------------

def loop_backward_memory_plan(cfm: ModelConfig, M: int, N: int, S: int = 0,
                              tall: bool = False) -> Tuple[int, int, int]:
    """(atoms per chunk of rows, atoms per block, shared bytes per block) --
    the layout ``make_plan`` in ``csrc/scann_loop_backward.cu`` walks (with
    the per-segment readout's vectors for a packed batch of S segments a
    slot; without the resident [M, max(D, G)] buffer in the tall build,
    ``tall``, whose chunks hold up to ``TALL_CHUNK_ROWS`` rows in the shared
    memory that buffer left). The atom block is the largest of 32, 16, 8
    (wide: and 4) whose plan fits a block's shared memory (the smallest
    one's plan if none does). A wide N (more than ``kbwd.MAX_CHUNK_ROWS``)
    walks one atom at a time in sub-chunks of that many rows, beside the
    atom's attention and d attention [N, H]. ``backward_plan`` is the plan
    of the build a launch takes."""
    r4 = lambda x: -(-x // 4) * 4
    D, G, O, H = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.num_head
    wd = max(D, G)
    lde = r4(cfm.embedding_dim + (10 if cfm.use_ring else 0))
    ldf = r4(kbwd.CGCNN_FEATURES) if cfm.feature == "cgcnn" else 0
    wide = is_wide_backward(N)
    cap = TALL_CHUNK_ROWS if tall and not wide else kbwd.MAX_CHUNK_ROWS
    for block in WIDE_BACKWARD_ATOM_BLOCKS if wide else ATOM_BLOCKS:
        block = min(block, M)
        chunk_atoms = max(1, min(block, cap // max(N, 1)))
        if wide:   # a sub-chunk, the atom's attention and d attention [N, H], the d query sum
            rows = kbwd.MAX_CHUNK_ROWS
            chunk = (rows * (2 * D + 4) + 3 * rows * (D + 4) + 2 * r4(N * H) + r4(rows * H)
                     + wd)
        else:
            chunk = kbwd.chunk_floats(chunk_atoms * N, D, H)
        work = max(chunk,
                   5 * block * wd + r4(block),
                   block * (2 * lde + ldf) + block * wd,
                   block * wd + 4 * wd + 5 * r4(M) + 3 * r4(O) + 4)   # the readout
        if S:
            work = max(work, block * wd + seg_backward_floats(S, wd, M, O))
        floats = ((0 if tall else M * wd) + 5 * block * wd + work + kbwd.N_WARPS * 2 * wd
                  + 2 * wd)
        if 4 * floats <= MAX_SHARED_BYTES:
            break
    return chunk_atoms, block, 4 * floats


def is_tall_backward(cfm: ModelConfig, M: int, N: int, S: int = 0) -> bool:
    """Whether the loop backward takes (config, M, N, S) in its tall build
    (``csrc/scann_loop_backward_tall.cu``): a narrow N (not
    ``is_wide_backward``) whose narrow plan does not fit a block's shared
    memory."""
    return (not is_wide_backward(N)
            and loop_backward_memory_plan(cfm, M, N, S)[2] > MAX_SHARED_BYTES)


def backward_plan(cfm: ModelConfig, M: int, N: int, S: int = 0, tall: bool = False
                  ) -> Tuple[int, int, int]:
    """``loop_backward_memory_plan`` of the build that takes (config, M, N,
    S): the narrow (or wide) plan where it fits, else the tall one; the tall
    one too where ``tall`` forces the tall build at a narrow N (the build
    runs its own plan at every shape)."""
    tall = not is_wide_backward(N) and (tall or is_tall_backward(cfm, M, N, S))
    return loop_backward_memory_plan(cfm, M, N, S, tall)


def cluster_size(B: int) -> int:
    """Thread blocks per structure of a loop launch (forward or backward) at
    batch size B:
    the largest of 4, 2, 1 with which the batch's clusters still run at once
    on the card (``CLUSTERS_AT_ONCE``). 4 up to 28 structures, 2 up to 66 (the
    MP2018 batch of 64 fills 128 of 132 SMs), 1 beyond."""
    for c, at_once in CLUSTERS_AT_ONCE.items():
        if B <= at_once:
            return c
    return 1


def backward_max_segments(cfm: ModelConfig, M: int, N: int) -> int:
    """The largest S a packed batch of shape (M, N) may have in the loop
    backward."""
    return largest_segments(lambda S: backward_plan(cfm, M, N, S)[2])


def backward_refusal(cfm: ModelConfig, M: int, N: int, S: int = 0) -> Optional[str]:
    """Why the loop backward does not take (config, M, N) at S segments a
    slot (0: unpacked), or None where it does: the gate, read by
    ``check_backward_supported`` and by the dispatch in
    ``Trainer.train_route``."""
    if not supports_loop(cfm):
        return ("use_attn_norm=False: the loop kernels always apply ResidualNorm; that "
                "configuration trains through the per-layer model "
                "(models.scann.scann_forward with use_pallas, under torch.autograd)")
    if M < 1:
        return f"M={M}: no atoms"
    reason = (kbwd.dtype_refusal(cfm) or kfwd.common_refusal(cfm, N, MAX_NEIGHBORS)
              or segment_refusal(S))
    if reason:
        return reason
    tall = is_tall_backward(cfm, M, N, S)
    nbytes = backward_plan(cfm, M, N, S)[2]
    if nbytes > MAX_SHARED_BYTES:
        reason = (f"M={M} atoms" + (f", S={S} segments" if S else "") + ": "
                  + ("one atom block and the readout's vectors" if tall
                     else "the resident buffer plus one atom block") + f" need {nbytes} "
                  f"bytes of shared memory, a block has {MAX_SHARED_BYTES}; larger "
                  "structures train through the per-layer model")
    return reason


def check_backward_supported(cfm: ModelConfig, M: int, N: int, S: int = 0) -> None:
    """Raise NotImplementedError for what the loop backward does not take."""
    reason = backward_refusal(cfm, M, N, S)
    if reason:
        raise NotImplementedError(reason)


def reference_loop_grad(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                        cfm: ModelConfig, ct_pred, ct_ga, dropout_rate: float = 0.0,
                        dropout_seed: Optional[int] = None, mol_base: int = 0
                        ) -> Dict[str, torch.Tensor]:
    """The plain version of ``loop_scann_grad``: gradients of sum(pred *
    ct_pred) + sum(ga * ct_ga) through the training forward
    (``kbwd.training_forward``; in bf16 with this kernel's segment pools)."""
    return kbwd.reference_fused_scann_grad(params, inputs, cfm, ct_pred, ct_ga, dropout_rate,
                                           dropout_seed or 0, mol_base, exact_pools=False)


def reference_loop_train_grads(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                               targets, cfm: ModelConfig, mrelu_head: bool = False,
                               dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
                               mol_base: int = 0
                               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The plain version of ``loop_scann_train_grads``: (pred [B, 1],
    gradients of 0.5 * sum((pred - t)^2)); mrelu is straight-through."""
    return kbwd.reference_fused_scann_train_grads(params, inputs, targets, cfm, mrelu_head,
                                                  dropout_rate, dropout_seed or 0, mol_base,
                                                  exact_pools=False)


def loop_stash_bytes(cfm: ModelConfig, B: int, M: int, N: int, mode: Optional[str]) -> int:
    """Bytes of the selective activation stash of one loop-backward launch
    at batch shape (B, M, N) (``loop_stash_scratch``): ns, u_pre and key
    [L, M*N, D] and the attention [L, M*N, H] at 4 bytes (``"f32"``) or 2
    (``"bf16"``), and in the bf16 stash o1 [L, M, D] in f32; 0 for the
    recompute schedule (None)."""
    if mode is None:
        return 0
    L, D, H, R = cfm.n_attention, cfm.local_dim, cfm.num_head, M * N
    big = 2 if mode == "bf16" else 4
    return B * L * (R * (3 * D + H) * big + (4 * M * D if mode == "bf16" else 0))


def loop_stash_mode(cfm: ModelConfig, B: int, M: int, N: int) -> Optional[str]:
    """The schedule of a loop-backward launch at (B, M, N), as
    ``scann_loop.py:165-183`` chooses it with the card's rule for "fits" (the
    stash against ``kbwd.STASH_BUDGET_BYTES`` of device memory per launch,
    not VMEM): ``"f32"`` (the selective stash, exact) where the f32 stash
    fits; ``"bf16"`` only where it does not, the halved one does and
    ``SCANN_TPU_LOOP_STASH_BF16=1``; else None (recompute).
    ``SCANN_TPU_LOOP_STASH=0`` forces None. A pure function of the config,
    the shape and the environment."""
    if os.environ.get("SCANN_TPU_LOOP_STASH", "1") == "0":
        return None
    if loop_stash_bytes(cfm, B, M, N, "f32") <= kbwd.STASH_BUDGET_BYTES:
        return "f32"
    if (os.environ.get("SCANN_TPU_LOOP_STASH_BF16", "0") == "1"
            and loop_stash_bytes(cfm, B, M, N, "bf16") <= kbwd.STASH_BUDGET_BYTES):
        return "bf16"
    return None


def loop_stash_scratch(cfm: ModelConfig, B: int, M: int, N: int, mode: Optional[str], device
                       ) -> Dict[str, Optional[torch.Tensor]]:
    """The selective stash of one launch (all None for the recompute
    schedule), in ``csrc/scann_loop_backward.cu``'s layout: ``stash_rows``
    [B, L, 3, M*N, D] (ns, u_pre, key) and ``stash_attn`` [B, L, M*N, H], f32
    or bfloat16, and ``stash_o1`` [B, L, M, D] f32 (the bf16 stash only)."""
    if mode is None:
        return dict.fromkeys(("stash_rows", "stash_attn", "stash_o1"))
    L, D, H, R = cfm.n_attention, cfm.local_dim, cfm.num_head, M * N
    big = torch.bfloat16 if mode == "bf16" else torch.float32
    return {"stash_rows": torch.empty((B, L, 3, R, D), device=device, dtype=big),
            "stash_attn": torch.empty((B, L, R, H), device=device, dtype=big),
            "stash_o1": (torch.empty((B, L, M, D), device=device, dtype=torch.float32)
                         if mode == "bf16" else None)}


def scratch_stash_mode(scratch: Dict[str, Optional[torch.Tensor]]) -> Optional[str]:
    """The stash mode a loop-backward scratch was allocated for."""
    rows = scratch.get("stash_rows")
    if rows is None:
        return None
    return "bf16" if rows.dtype == torch.bfloat16 else "f32"


# --- the plain version of the selective stash -----------------------------------

LOOP_STASH_BF16_KEYS = ("ns", "u_pre", "key", "attn")


def loop_stash(acts, mode: str):
    """What the loop kernel's forward pass stashes of a layer
    (``scann_loop.py:597-622``): ns, u_pre, key and attn (before dropout),
    rounded to bfloat16 in the bf16 stash, and o1 in f32."""
    r = dots.round_bf16 if mode == "bf16" else (lambda x: x)
    out = {k: r(acts[k]) for k in LOOP_STASH_BF16_KEYS}
    out["o1"] = acts["o1"]
    return out


def loop_rebuild(st, layer, w, c_in, g_in):
    """The reverse walk's acts from the selective stash, as ``acts_from_stash``
    (``scann_loop.py:726-760``): geo_term, LN_g's x-hat and rsqrt from u_pre
    and the layer's input geometry; the query from its input centers; ctx
    from the stashed attention (dropout replayed) and keys, for the attention
    LayerNorm's statistics; s1, h1 and the ResidualNorm's statistics from
    the stashed o1."""
    cfm = layer.cfm
    ns, u_pre, key, attn, o1 = st["ns"], st["u_pre"], st["key"], st["attn"], st["o1"]
    if cfm.g_update:
        geo_term, g_xhat, g_inv = kfwd._ln_fwd(swish(u_pre) + g_in, w["lng_s"], w["lng_b"])
    else:
        geo_term, g_xhat, g_inv = swish(u_pre) * layer.weight[..., None], None, None
    query = layer.mm(c_in, w["wq"]) + w["bq"]
    attn_used = attn * layer.amask if layer.amask is not None else attn
    ctx = (layer.lanes(attn_used) * layer.nmask[..., None] * key).sum(dim=2)
    _, o_xhat, o_inv = kfwd._ln_fwd(ctx + query, w["ln_s"], w["ln_b"])
    s1 = layer.mm(o1, w["wr1"]) + w["br1"]
    h1 = swish(s1)
    h2 = layer.mm(h1, w["wr2"]) + w["br2"]
    if layer.res_mask is not None:
        h2 = h2 * layer.res_mask
    _, c_xhat, c_inv = kfwd._ln_fwd(o1 + h2, w["rln_s"], w["rln_b"])
    return dict(ns=ns, u_pre=u_pre, geo_term=geo_term, g_xhat=g_xhat, g_inv=g_inv, key=key,
                query=query, attn=attn, attn_used=attn_used, o1=o1, o_xhat=o_xhat, o_inv=o_inv,
                s1=s1, h1=h1, c_xhat=c_xhat, c_inv=c_inv)


def reference_loop_stash_grad(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                              cfm: ModelConfig, ct_pred, ct_ga, dropout_rate: float = 0.0,
                              dropout_seed: Optional[int] = None, mol_base: int = 0,
                              mode: str = "bf16") -> Dict[str, torch.Tensor]:
    """The plain version of ``loop_scann_grad`` with the selective stash
    ``mode``: the reverse walk of ``scann_loop.py:762-886`` on
    ``loop_rebuild``'s acts (``kbwd.reference_stash_grad``). In the f32
    stash it computes the function ``reference_loop_grad`` does."""
    return kbwd.reference_stash_grad(params, inputs, cfm, ct_pred, ct_ga, dropout_rate,
                                     dropout_seed or 0, mol_base, mode, loop_stash,
                                     loop_rebuild, exact_pools=False)


def reference_loop_stash_train_grads(params: Dict[str, torch.Tensor],
                                     inputs: Dict[str, torch.Tensor], targets, cfm: ModelConfig,
                                     mrelu_head: bool = False, dropout_rate: float = 0.0,
                                     dropout_seed: Optional[int] = None, mol_base: int = 0,
                                     mode: str = "bf16"
                                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The plain version of ``loop_scann_train_grads`` with the selective
    stash ``mode``: (pred, gradients of 0.5 * sum((pred - t)^2))."""
    return kbwd.reference_stash_train_grads(params, inputs, targets, cfm, mrelu_head,
                                            dropout_rate, dropout_seed or 0, mol_base, mode,
                                            loop_stash, loop_rebuild, exact_pools=False)


def loop_backward_scratch(packed: Dict[str, torch.Tensor], cfm: ModelConfig, B: int, M: int,
                          N: int, cluster: Optional[int] = None, stash=kbwd.AUTO, S: int = 0,
                          tall: Optional[bool] = None) -> Dict[str, Optional[torch.Tensor]]:
    """The global scratch of one loop-backward launch at batch shape (B, M,
    N) and S segments a slot: that of the molecule backward with the last
    centers stashed too and one gradient row per block ([B * cluster, P];
    ``cluster`` defaults to ``cluster_size(B)``), plus the [B, M, D] d(layer
    output), the selective stash of ``stash`` (``loop_stash_mode``'s by
    default) and, for the tall build (``tall``, ``is_tall_backward`` by
    default), each block's GA keys and d(layer input) partial ``tall`` [B *
    C, M, G + D]. A trainer allocates it once per shape."""
    cluster = cluster_size(B) if cluster is None else cluster
    tall = is_tall_backward(cfm, M, N, S) if tall is None else tall
    dev = packed["wde"].device
    scratch = kbwd.allocate_scratch(packed, cfm, B, M, N, cfm.n_attention + 1, cluster)
    scratch["dcenters"] = torch.empty((B, M, cfm.local_dim), device=dev, dtype=torch.float32)
    for key, shape in (("wide_keys", wide_keys_shape_for(cfm, B, N, cluster,
                                                         is_wide_backward(N))),
                       ("tall", tall_shape_for(cfm, B, M, cluster, tall, backward=True))):
        scratch[key] = (None if shape is None
                        else torch.empty(shape, device=dev, dtype=torch.float32))
    scratch.update(loop_stash_scratch(
        cfm, B, M, N, kbwd.resolve_stash(stash, loop_stash_mode, cfm, B, M, N), dev))
    return scratch


def launch_loop_backward(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                         cfm: ModelConfig, ct: torch.Tensor, ct_ga: Optional[torch.Tensor],
                         one_shot: bool, mrelu_head: bool = False, dropout_rate: float = 0.0,
                         seed: int = 0, mol_base: int = 0,
                         scratch: Optional[Dict[str, Optional[torch.Tensor]]] = None,
                         cluster: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check CUDA inputs and launch the loop backward and its row reduction
    with ``pack_params`` output (index ranges are the caller's, as
    ``kernels.scann_forward.launch_scann_forward`` says). ``ct`` [B] is d
    pred, or the targets when ``one_shot`` ([B, S] for a packed batch); ``ct_ga``
    [B, M] (ignored when ``one_shot``); ``scratch``
    from ``loop_backward_scratch`` at this batch shape, cluster size, stash
    mode and build (allocated here when None; one of another mode or build
    raises); ``cluster`` blocks per structure (1, 2 or 4; ``cluster_size(B)``
    when None). The build is ``backward_library``'s, the schedule
    ``loop_stash_mode``'s. Returns
    (flat gradients [P], pred [B], or [B * S] packed)."""
    dev = packed["wde"].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    check_backward_supported(cfm, inputs["atomic"].shape[1], inputs["neighbors"].shape[2],
                             segment_count(inputs))
    kfwd._check_shapes(inputs, cfm, dev)
    return _launch_backward(packed, inputs, cfm, ct, ct_ga, one_shot, mrelu_head, dropout_rate,
                            seed, mol_base, scratch, cluster)


kbwd.reset_counts(launch_loop_backward)


def _launch_backward(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                     cfm: ModelConfig, ct: torch.Tensor, ct_ga: Optional[torch.Tensor],
                     one_shot: bool, mrelu_head: bool = False, dropout_rate: float = 0.0,
                     seed: int = 0, mol_base: int = 0,
                     scratch: Optional[Dict[str, Optional[torch.Tensor]]] = None,
                     cluster: Optional[int] = None, stash=kbwd.AUTO, tall: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch itself, on inputs ``launch_loop_backward`` accepted, with
    the schedule ``stash`` (``kbwd.AUTO``: ``loop_stash_mode``'s; None,
    ``"f32"`` or ``"bf16"`` force one, for the checks that hold one schedule
    against another), in the tall build where ``is_tall_backward`` or
    ``tall`` (True forces it at a shape the narrow build takes, with the
    tall plan, for the checks that hold the two builds against each
    other)."""
    B, M = inputs["atomic"].shape[:2]
    N = inputs["neighbors"].shape[2]
    seg, S = segment_arguments(inputs)
    mode = kbwd.resolve_stash(stash, loop_stash_mode, cfm, B, M, N)
    cluster = cluster_size(B) if cluster is None else cluster
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster={cluster}: the loop backward launches with {CLUSTER_SIZES}")
    name = backward_library(cfm, M, N, S, tall)
    tall = name.startswith("scann_loop_backward_tall")
    chunk_atoms, atom_block, _ = backward_plan(cfm, M, N, S, tall)
    if scratch is None:
        scratch = loop_backward_scratch(packed, cfm, B, M, N, cluster, mode, S, tall)
    elif (scratch["dcenters"].shape != (B, M, cfm.local_dim)
          or scratch["rows"].shape[0] != B * cluster or scratch_stash_mode(scratch) != mode
          or wide_keys_shape(scratch["wide_keys"])
          != wide_keys_shape_for(cfm, B, N, cluster, is_wide_backward(N))
          or wide_keys_shape(scratch.get("tall"))
          != tall_shape_for(cfm, B, M, cluster, tall, backward=True)):
        raise ValueError(f"scratch of shape {tuple(scratch['dcenters'].shape)} with "
                         f"{scratch['rows'].shape[0]} gradient rows, stash "
                         f"{scratch_stash_mode(scratch)} and tall scratch "
                         f"{wide_keys_shape(scratch.get('tall'))} handed to a batch of shape "
                         f"{(B, M, cfm.local_dim)} at {cluster} blocks per structure, stash "
                         f"{mode}, in the {name} build")
    tensors, dims, scalars, rng, offsets, flat, pred = kbwd.launch_arguments(
        packed, inputs, cfm, ct, ct_ga, one_shot, mrelu_head, dropout_rate, seed, mol_base,
        chunk_atoms, scratch)
    wide = is_wide_backward(N)
    kfwd.call_kernel(name, name, packed["wde"].device,
                     tensors + [scratch["dcenters"], seg, scratch["stash_rows"],
                                scratch["stash_attn"], scratch["stash_o1"],
                                scratch["tall"] if tall else scratch["wide_keys"]],
                     dims + [atom_block, S, cluster, kbwd.stash_element_bytes(mode)], scalars,
                     rng, offsets, flat)
    kbwd.count_launch(launch_loop_backward, cfm, mode)
    launch_loop_backward.wide_launches += wide
    launch_loop_backward.tall_launches += tall
    return flat, pred


def max_active_clusters(cfm: ModelConfig, B: int, M: int, N: int, cluster: int) -> int:
    """How many clusters of ``cluster`` loop-backward blocks at this shape the
    card runs at once (``cudaOccupancyMaxActiveClusters``); a launch of more
    than that many structures takes more than one wave. The kernel of the
    build that launches (M, N) in the config's operand mode answers
    (``backward_library``; every build exports its own)."""
    import ctypes

    from scann_tpu_torch.kernels._build import load_library

    chunk_atoms, atom_block, _ = backward_plan(cfm, M, N)
    dims = [B, M, N, cfm.local_dim, cfm.num_head, cfm.embedding_dim, cfm.num_gaussian,
            cfm.global_dim, cfm.dense_out, cfm.n_attention, kbwd.CGCNN_FEATURES, 0,
            int(cfm.feature == "cgcnn"), int(cfm.use_ring), 0, 0, 0, 0, chunk_atoms, 0, 0,
            atom_block, 0, cluster]
    name = backward_library(cfm, M, N)
    fn = getattr(load_library(name), name + "_max_clusters")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn((ctypes.c_int * len(dims))(*dims), cluster)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with CUDA error {-n}")
    return n


def loop_scann_grad(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                    cfm: ModelConfig, ct_pred, ct_ga, dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None, mol_base: int = 0
                    ) -> Dict[str, torch.Tensor]:
    """Parameter gradients of (pred, ga) contracted with (ct_pred [B] or
    [B, 1], ct_ga [B, M] or [B, M, 1]) through the loop backward kernel."""
    dev = inputs["atomic"].device
    check_backward_supported(cfm, inputs["atomic"].shape[1], inputs["neighbors"].shape[2],
                             segment_count(inputs))
    if dev.type == "cpu":
        B, M = inputs["atomic"].shape[:2]
        if loop_stash_mode(cfm, B, M, inputs["neighbors"].shape[2]) == "bf16":
            return reference_loop_stash_grad(params, inputs, cfm, ct_pred, ct_ga, dropout_rate,
                                             dropout_seed, mol_base)
        return reference_loop_grad(params, inputs, cfm, ct_pred, ct_ga, dropout_rate,
                                   dropout_seed, mol_base)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_index_ranges(inputs, cfm)
    packed = pack_params(params, cfm)
    flat, _ = launch_loop_backward(packed, inputs, cfm, torch.as_tensor(ct_pred, device=dev),
                                   torch.as_tensor(ct_ga, device=dev), False, False,
                                   dropout_rate, dropout_seed or 0, mol_base)
    return kbwd.grads_from_flat(flat, packed, cfm)


def loop_scann_train_grads(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                           targets, cfm: ModelConfig, mrelu_head: bool = False,
                           dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
                           mol_base: int = 0
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-shot crystal training: forward, residual and backward in one
    launch. Returns (pred [B, 1], raw gradients of 0.5 * sum((pred - t)^2));
    the caller turns them into RMSE + l2 gradients (``train.loop``)."""
    dev = inputs["atomic"].device
    check_backward_supported(cfm, inputs["atomic"].shape[1], inputs["neighbors"].shape[2],
                             segment_count(inputs))
    if dev.type == "cpu":
        B, M = inputs["atomic"].shape[:2]
        if loop_stash_mode(cfm, B, M, inputs["neighbors"].shape[2]) == "bf16":
            return reference_loop_stash_train_grads(params, inputs, targets, cfm, mrelu_head,
                                                    dropout_rate, dropout_seed, mol_base)
        return reference_loop_train_grads(params, inputs, targets, cfm, mrelu_head,
                                          dropout_rate, dropout_seed, mol_base)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_index_ranges(inputs, cfm)
    packed = pack_params(params, cfm)
    flat, pred = launch_loop_backward(packed, inputs, cfm, torch.as_tensor(targets, device=dev),
                                      None, True, mrelu_head, dropout_rate, dropout_seed or 0,
                                      mol_base)
    return pred.view(inputs["atomic"].shape[0], -1), kbwd.grads_from_flat(flat, packed, cfm)


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
        S = max(segment_count(ctx.inputs), 1)
        ct_pred = d_pred if d_pred is not None else torch.zeros(B, S, device=dev)
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


def loop_recompute_flops(cfm: ModelConfig, B: int, M: int, N: int,
                         stash: Optional[str] = None) -> int:
    """FLOPs that the loop backward's schedule adds to ``loop_backward_flops``
    at one padded batch: in the reverse walk each layer's ResidualNorm, query
    (and cw), (atom, neighbour) rows and energies again (the context is
    stashed); in the readout's second pass after_Lc and the GA queries; the
    embedding and the SCANN+ geometry embedding. Under the selective stash
    (``"f32"``, ``"bf16"``) a layer forms only its [M, D] products again
    (query and the ResidualNorm's two), and the bf16 stash also its context
    from the rounded attention and keys in the forward pass. At a wide N the
    recompute schedule forms the rows in both passes of the reverse walk.
    Elementwise work, softmax and LayerNorm are left out, as in
    ``forward_flops``."""
    D, K, E, G = cfm.local_dim, cfm.num_gaussian, cfm.embedding_dim, cfm.global_dim
    R = M * N
    mm = lambda rows, k, n: 2 * rows * k * n
    f = mm(M, D, G) + mm(M, G, G)                                  # readout, second pass
    if stash:
        per_layer = 3 * mm(M, D, D) + (2 * R * D if stash == "bf16" else 0)
    else:
        per_layer = 2 * mm(M, D, D)                                # ResidualNorm
        per_layer += (2 if cfm.g_update else 1) * mm(M, D, D)      # query (and cw)
        rows = (mm(R, 2 * D, D) if cfm.g_update else mm(R, K, D)) + mm(R, D, D)
        per_layer += rows * (2 if is_wide_backward(N) else 1)     # rows (wide: both passes)
        per_layer += 2 * R * D                                     # energies
    f += cfm.n_attention * per_layer
    f += mm(M, E + (10 if cfm.use_ring else 0), D)                 # embedding
    if cfm.feature == "cgcnn":
        f += mm(M, kbwd.CGCNN_FEATURES, E)
    if cfm.g_update:
        f += 2 * mm(R, K, D)                                       # geometry embedding
    return B * f
