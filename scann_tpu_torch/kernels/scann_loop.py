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
  and differ in where a structure's state lives. The narrow build keeps only
  the current centers [M, max(D, G)] in shared memory for a whole layer and every
  other per-atom tensor for one block of 32, 16 or 8 atoms at a time, so it
  needs M * 512 bytes + 108 to 133 KB at D = G = 128: M <= 237 (at N = 32)
  fits a block's 227 KB. It shares the molecule kernel's tiles: chunks
  of at most 64 (atom, neighbour) rows, D, G, O multiples of 4 up to 256
  (``kfwd.MAX_WIDTH``). ``use_attn_norm=False`` is refused.
- Widths past 128 (``kfwd.is_d256``): the tall and wide builds of widths up
  to 256 (``csrc/scann_loop_tall_d256.cu``, ``scann_loop_wide_d256.cu``: 8
  values of a row a lane in the warp LayerNorms; ``forward_library``
  names them, ``.d256_launches`` counts them). The narrow build is not
  launched there (``is_tall`` holds at every narrow N); the tall build's
  chunks fall to 32 rows where 64 do not fit (``l2_memory_plan``), and it
  takes N <= ``D256_TALL_MAX_N`` = 32, the wide build the rest
  (``is_wide_forward``). The loop backward trains such a model too, in its
  tall and wide builds of widths up to 256 (below).
- Tall structures, N <= 64 and M past that plan: the tall build
  ``csrc/scann_loop_tall.cu`` (built at its first launch, both operand
  modes) keeps the centers in global memory, which L2 holds: a ping-pong [2,
  B, M, D] (``loop_forward_scratch``'s ``next_centers``), and the readout's
  GA keys and queries in ``readout`` [B, M, 2G]. Its plan
  (``l2_memory_plan``) drops the M * 512 bytes and holds two chunk operand
  buffers: each chunk is staged by the copy engine (one bulk copy a row,
  through L2) while the one before it runs. Atom blocks of 32 take M into
  the thousands, past every M the TPU kernel takes. Its arithmetic and sums
  are the narrow build's: at a shape both take (the private ``_launch(...,
  tall=True)`` forces it there) the outputs are the same bits, in either
  operand mode.
  ``is_tall`` is its rule, ``forward_library`` names the build of every
  launch, and ``.tall_launches`` counts these launches.
- Wide neighbour lists, 64 < N <= 256 (``MAX_NEIGHBORS``): the wide build
  ``csrc/scann_loop_wide.cu`` (built at its first launch, both operand
  modes), with the tall build's centers in global memory and readout rows:
  one atom at a time, its rows in sub-chunks of 64, the softmax over all N
  from its energy row in shared memory, its keys in shared memory where the
  plan holds them (N <= 200 at D = 128) or else in a per-block scratch
  (``wide_keys``, [B * C, N, D], right after ``readout`` in one
  allocation), the context over all 256 threads (each half of the
  neighbours summed, then the halves added). No resident centers, so its
  gate too takes M into the thousands at every N. ``.wide_launches`` counts
  these launches.
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
- It launches a cluster of ``forward_cluster(cfm, B, M, N, S)`` blocks per
  structure (``launch_loop_forward(..., cluster=C)`` takes another C), each
  block on a contiguous share of the atoms; the new centers of a layer cross
  the cluster through global memory. The narrow build takes the backward's
  ``cluster_size(B)`` (1, 2 or 4); the tall and wide builds the largest C
  up to 16 whose B clusters the card runs at once
  (``max_active_forward_clusters``: 16 for one structure, 6 at B = 16, 2 at
  64 on an H100 SXM), so that small batches fill the card. Its products run as
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
  ``.wide_launches``), one atom at a time in sub-chunks of
  ``WIDE_CHUNK_ROWS`` = 64 rows beside the atom's attention and d attention
  [N, H]. The resident buffer's roles take the tall build's global homes
  there too (the ``tall`` scratch, with each block's rows of one atom
  ``wide_rows`` [B * C, 3, N, D] right after it in one allocation), so its
  plan does not grow with M: atom blocks of 16 up to N = 184 and 8 beyond
  at D = 128 (``WIDE_BACKWARD_ATOM_BLOCKS``), M into the thousands. Its reverse walk
  runs the softmax backward over all N before the rows' backward; where one
  sub-chunk holds an atom's list (N <= 64) it keeps the first pass's rows,
  past it the recompute schedule's second pass stages them back from
  ``wide_rows``, so the reverse walk forms each row once.
- Widths past 128 (``kfwd.is_d256``): the tall and wide builds of widths up
  to 256 (``csrc/scann_loop_backward_tall_d256.cu``,
  ``scann_loop_backward_wide_d256.cu`` and their ``_bf16`` twins: 8 values
  of a row a lane in the warp LayerNorms; ``backward_library`` names them,
  ``.d256_launches`` counts them), in all three schedules. The narrow build
  is not launched there (``is_tall_backward`` holds at every N <= 32): the
  tall build takes the first of ``kfwd.CHUNK_ROWS`` = 64, 32, 16 rows a
  chunk that fits (32 rows with atom blocks of 8 at D = 256), the wide one
  the first of ``D256_WIDE_CHUNK_ROWS`` = (64, 32) rows a sub-chunk that
  fits (``wide_sub_chunk``: 64 at D = 136 with atom blocks of 8, 32 with
  atom blocks of 4 at (80, 96) and D = 256). Their design (from a
  phase split: the weight gradients' adds into each block's gradient row,
  a quarter of the time on an NVIDIA H100 80GB HBM3 at 700 W, lead at D =
  256): every such add is a reduction
  that the warp does not wait for, and a launch takes up to 8 blocks a
  structure (``backward_cluster``: the largest C whose B clusters the card
  runs at once, so that a batch of 16 fills 96 SMs rather than 64). So a
  D = 256 model trains on #4 at QM9 (32, 16), which #2 refuses past 128
  columns (``kbwd.MAX_WIDTH``), and at MP2018 (96, 32) and (48, 96).
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

import math
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
# atoms, where 8 do not fit beside the readout's [M] vectors (M near 10^4 at
# D = 128)
WIDE_BACKWARD_ATOM_BLOCKS = ATOM_BLOCKS + (4,)
# the tall loop backward's chunk of (atom, neighbour) rows (kTallChunkRows of
# csrc/scann_loop_backward.cu): two atoms at N = 32, in the shared memory the
# resident buffer left; the narrow build keeps kbwd.MAX_CHUNK_ROWS
TALL_CHUNK_ROWS = 64
# the wide loop backward's sub-chunk of one atom's rows (kWideChunkRows), in the
# shared memory the resident buffer left there too; past 128 columns (the
# *_d256 builds, ``build_plan`` of the CUDA source) the first of these whose
# plan fits a block: 64 rows up to D = 152 or so, 32 at D = 256
WIDE_CHUNK_ROWS = 64
D256_WIDE_CHUNK_ROWS = (WIDE_CHUNK_ROWS, WIDE_CHUNK_ROWS // 2)
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
# Blocks per structure the tall and wide forwards (whose centers live in L2)
# may launch with: any size up to 16 (past 8 a non-portable cluster, which
# their launchers opt into). ``forward_cluster`` takes the largest whose B
# clusters the card runs at once, so that small batches fill it (one
# structure: 16 blocks rather than 4).
FORWARD_CLUSTER_SIZES = tuple(range(16, 0, -1))
# Blocks per structure the loop backward's builds past 128 columns (the
# *_d256 builds, kMaxCluster = 8 there) may launch with: any portable size up
# to 8. ``backward_cluster`` takes the largest whose B clusters the card runs
# at once, so that a small batch fills it (6 at B = 16 on a card that runs 15
# clusters of 8 or 7, 2 at the MP2018 recipe batch of 64, 1 at 128).
D256_CLUSTER_SIZES = tuple(range(8, 0, -1))
# The largest N of the loop forward's narrow and tall builds past 128 columns
# (``kfwd.is_d256``; kTallMaxN of csrc/scann_loop.cu): two tall chunk
# buffers of more rows do not fit a block's shared memory at D = 256, so the
# wide build takes N > 32 there (N > 64 up to 128 columns).
D256_TALL_MAX_N = 32


def supports_loop(cfm: ModelConfig) -> bool:
    """Atomic or cgcnn features, with or without ring features, SCANN or
    SCANN+, with or without attention dropout; only ``use_attn_norm=False``
    (no published config) is left to the per-layer model."""
    return cfm.use_attn_norm


def is_wide_forward(cfm: ModelConfig, N: int) -> bool:
    """Whether the loop forward takes N neighbours in its wide build
    (``csrc/scann_loop_wide.cu``, or ``scann_loop_wide_d256.cu`` past 128
    columns): N > 64 (``is_wide``, #5's rule too), and past 128 columns N >
    ``D256_TALL_MAX_N``."""
    return is_wide(N) or (kfwd.is_d256(cfm) and N > D256_TALL_MAX_N)


def loop_memory_plan(cfm: ModelConfig, M: int, N: int, S: int = 0, tall: bool = False
                     ) -> Tuple[int, int, int, int]:
    """(atoms per chunk, atoms per block, floats of the work region, shared
    bytes per block) -- the layout ``make_plan`` in the CUDA source walks.
    The narrow build: the centers [M, max(D, G)], two slots [block, max(D,
    G) + 4], and a work region that holds a chunk's buffers, the embedding's
    staging, the ResidualNorm's h2 or the readout's block and vectors (per
    segment for a packed batch of S segments a slot). The tall (``tall``)
    and wide (``is_wide_forward``) builds keep the centers in global memory:
    ``l2_memory_plan``. The atom block is the largest of 32, 16, 8 whose plan
    fits a block's shared memory (the smallest one's plan if none does).
    ``forward_plan`` is the plan of the build a launch takes."""
    if tall or is_wide_forward(cfm, N):
        return l2_memory_plan(cfm, M, N, S)[:4]
    r4 = lambda x: -(-x // 4) * 4
    D, G, O, H = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.num_head
    wd = max(D, G)
    for block in ATOM_BLOCKS:
        block = min(block, M)
        chunk_atoms = max(1, min(block, MAX_CHUNK_ROWS // max(N, 1)))
        work = max(kfwd.forward_chunk_floats(chunk_atoms * N, D, H),
                   kfwd.embedding_stage_floats(cfm, block), block * (wd + 4),
                   block * wd + 2 * wd + 2 * r4(M) + r4(O))
        if S:
            work = max(work, block * wd + seg_forward_floats(S, wd, M, O))
        floats = M * wd + 2 * block * (wd + 4) + work
        if 4 * floats <= MAX_SHARED_BYTES:
            break
    return chunk_atoms, block, work, 4 * floats


def l2_memory_plan(cfm: ModelConfig, M: int, N: int, S: int = 0
                   ) -> Tuple[int, int, int, int, bool]:
    """The plan of the tall and wide builds (``l2_plan`` in the CUDA source),
    whose centers live in global memory: (atoms per chunk, atoms per block,
    floats of the work region, shared bytes per block, whether the wide
    atom's keys are in shared memory). Two slots [block, max(D, G) + 4],
    then the work region: the front, max(rows (D + 4) + attention, block
    (max(D, G) + 4)) (a chunk's product and attention, the wide atom's
    energies [N, H] in place of the attention; the ResidualNorm's h2), the
    chunk operand buffers [rows, 2D + 4] (two in the tall build, which
    stages the next chunk while one runs; one sub-chunk of 64 rows in the
    wide build), the index ring (two slots of a chunk's or a wide atom's
    neighbour indices, 2 x rows or 2 N rounded up to 4 floats, so that the
    keys after it stay 16-byte aligned at an odd N), the buffers' two
    mbarriers (4 floats) and, in the wide build where they fit, the atom's
    keys [N, D]; or the embedding's staging, or the readout's block and
    vectors. The wide
    build takes the keys into shared memory at the largest atom block that
    fits them, else leaves them in global memory (``loop_forward_scratch``'s
    ``wide_keys``). The tall build's chunk is the first of
    ``kfwd.CHUNK_ROWS`` rows (whole atoms) whose plan fits (64 up to 128
    columns, 32 at D = 256). None of it grows with M but the readout's [M]
    vectors, so the plan takes M into the thousands; where nothing fits, the
    plan of the first chunk size at the smallest block."""
    r4 = lambda x: -(-x // 4) * 4
    D, G, O, H = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.num_head
    wd = max(D, G)
    wide = is_wide_forward(cfm, N)
    first = None
    for most_rows in ((MAX_CHUNK_ROWS,) if wide else kfwd.CHUNK_ROWS):
        for smem_keys in ((True, False) if wide else (False,)):
            for block in ATOM_BLOCKS:
                block = min(block, M)
                chunk_atoms = max(1, min(block, most_rows // max(N, 1)))
                rows = MAX_CHUNK_ROWS if wide else chunk_atoms * N
                front = max(rows * (D + 4) + r4(N * H if wide else rows * H), block * (wd + 4))
                chunk = (front + (1 if wide else 2) * rows * (2 * D + 4)
                         + r4(2 * (N if wide else rows)) + 4 + (N * D if smem_keys else 0))
                work = max(chunk, kfwd.embedding_stage_floats(cfm, block),
                           block * wd + 2 * wd + 2 * r4(M) + r4(O))
                if S:
                    work = max(work, block * wd + seg_forward_floats(S, wd, M, O))
                floats = 2 * block * (wd + 4) + work
                if 4 * floats <= MAX_SHARED_BYTES:
                    return chunk_atoms, block, work, 4 * floats, smem_keys
        first = first or (chunk_atoms, block, work, 4 * floats, smem_keys)
    return first


def is_tall(cfm: ModelConfig, M: int, N: int, S: int = 0) -> bool:
    """Whether the loop forward takes (config, M, N, S) in its tall build
    (``csrc/scann_loop_tall.cu``): a narrow N (not ``is_wide_forward``)
    whose narrow plan does not fit a block's shared memory, so the centers
    live in global memory; past 128 columns every narrow N (the narrow build
    has no such build: ``scann_loop_tall_d256.cu`` takes them)."""
    return not is_wide_forward(cfm, N) and (
        kfwd.is_d256(cfm) or loop_memory_plan(cfm, M, N, S)[3] > MAX_SHARED_BYTES)


def forward_plan(cfm: ModelConfig, M: int, N: int, S: int = 0, tall: bool = False
                 ) -> Tuple[int, int, int, int]:
    """``loop_memory_plan`` of the build that takes (config, M, N, S): the
    narrow (or wide) plan where it fits, else the tall one; the tall one too
    where ``tall`` forces the tall build at a narrow N (the build runs its
    own plan at every shape)."""
    return loop_memory_plan(cfm, M, N, S, tall or is_tall(cfm, M, N, S))


def is_wide_backward(N: int) -> bool:
    """Whether the loop backward takes N neighbours in its wide build
    (``csrc/scann_loop_backward_wide.cu``)."""
    return N > kbwd.MAX_CHUNK_ROWS


def forward_library(cfm: ModelConfig, M: int, N: int, S: int = 0, tall: bool = False
                    ) -> Tuple[str, str]:
    """(library, entry-point prefix) of the loop forward's build that takes
    (config, M, N, S): the wide one (``csrc/scann_loop_wide.cu``) where
    ``is_wide_forward``, the tall one (``csrc/scann_loop_tall.cu``) where
    ``is_tall`` or ``tall`` forces it, else the narrow one; past 128
    columns (``kfwd.is_d256``) the wide or tall one of widths up to 256
    (``*_d256``). Each build holds both operand modes
    (``kfwd.operand_mode(cfm)`` is a launch argument), so the library is the
    same for f32 and bf16. The one place that chooses."""
    d256 = "_d256" if kfwd.is_d256(cfm) else ""
    if is_wide_forward(cfm, N):
        return "scann_loop_wide" + d256, "scann_loop_forward_wide" + d256
    if tall or is_tall(cfm, M, N, S):
        return "scann_loop_tall" + d256, "scann_loop_forward_tall" + d256
    return "scann_loop", "scann_loop_forward"


def backward_library(cfm: ModelConfig, M: int, N: int, S: int = 0, tall: bool = False) -> str:
    """The loop backward's build that takes (config, M, N, S), the name of
    its library and its entry points: the wide one where
    ``is_wide_backward``, the tall one where ``is_tall_backward`` or
    ``tall`` forces it, else the narrow one; past 128 columns
    (``kfwd.is_d256``) the wide or tall one of widths up to 256
    (``*_d256``); each in the config's operand mode (``kbwd.kernel_name``:
    ``<build>_bf16`` in bf16, a source of its own). The one place that
    chooses."""
    d256 = "_d256" if kfwd.is_d256(cfm) else ""
    if is_wide_backward(N):
        return kbwd.kernel_name("scann_loop_backward_wide" + d256, cfm)
    if tall or is_tall_backward(cfm, M, N, S):
        return kbwd.kernel_name("scann_loop_backward_tall" + d256, cfm)
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
    l2 = is_wide_forward(cfm, N) or is_tall(cfm, M, N, S)
    nbytes = forward_plan(cfm, M, N, S)[3]
    if nbytes > MAX_SHARED_BYTES:
        reason = (f"M={M} atoms" + (f", S={S} segments" if S else "") + ": "
                  + ("one atom block and the readout's vectors" if l2
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
    (``forward_cluster`` when None): the SCANN+ geometry [B * M * N * D]
    (for SCANN, None in the narrow build and in the tall and wide builds the
    distance RBF table [B * M * N * round4(K)], formed once a launch), the
    new centers [B, M, D] (the tall and wide builds' ping-pong centers [2,
    B, M, D]), for the tall and wide builds the readout
    rows ``readout`` [B, M, 2G] (each atom's GA keys and queries) and, for a
    wide N whose plan keeps the atom's keys out of shared memory, each
    block's keys ``wide_keys`` [B * C, N, D] right after them in the same
    allocation (the kernel takes one pointer; else None). ``tall`` defaults
    to ``is_tall``; True is the scratch of a launch forced into the tall
    build. Its contents mean nothing between launches; a launch allocates its
    own unless it is handed one, and refuses one of another build."""
    D = cfm.local_dim
    tall = is_tall(cfm, M, N, S) if tall is None else tall
    l2 = tall or is_wide_forward(cfm, N)
    empty = lambda *shape: torch.empty(shape, device=device, dtype=torch.float32)
    # SCANN+: the geometry, D columns a row; SCANN in the tall and wide
    # builds: the distance RBF table, round4(K) columns a row
    cols = D if cfm.g_update else (-(-cfm.num_gaussian // 4) * 4 if l2 else 0)
    scratch = {"geo": empty(B * M * N * cols) if cols else None,
               "next_centers": empty(2, B, M, D) if l2 else empty(B, M, D),
               "readout": None, "wide_keys": None}
    if l2:
        rows = readout_shape_for(cfm, B, M)
        keys = None
        if is_wide_forward(cfm, N) and not l2_memory_plan(cfm, M, N, S)[4]:
            C = forward_cluster(cfm, B, M, N, S) if cluster is None else cluster
            keys = wide_keys_shape_for(cfm, B, M, N, C, S)
        n = math.prod(rows)
        buf = empty(n + (math.prod(keys) if keys else 0))
        scratch["readout"] = buf[:n].view(rows)
        if keys:
            scratch["wide_keys"] = buf[n:].view(keys)
    return scratch


def readout_shape_for(cfm: ModelConfig, B: int, M: int) -> Tuple[int, int, int]:
    """The tall and wide loop forwards' readout rows [B, M, 2G]: each atom's
    GA keys, then its GA queries, written by the block that owns the atom
    and read by every block of its cluster."""
    return (B, M, 2 * cfm.global_dim)


def wide_keys_shape_for(cfm: ModelConfig, B: int, M: int, N: int, cluster: int, S: int = 0
                        ) -> Optional[Tuple[int, int, int]]:
    """The wide loop forward's global key scratch [B * C, N, D] (one atom's
    keys a block), where ``l2_memory_plan`` leaves them out of shared
    memory; None where N is not wide (``is_wide_forward``) or the keys are in
    shared memory."""
    if not is_wide_forward(cfm, N) or l2_memory_plan(cfm, M, N, S)[4]:
        return None
    return (B * cluster, N, cfm.local_dim)


def wide_keys_shape(t: Optional[torch.Tensor]) -> Optional[Tuple[int, ...]]:
    """The shape of a kept scratch's key scratch (None where it has none)."""
    return None if t is None else tuple(t.shape)


def wide_rows_shape_for(cfm: ModelConfig, B: int, N: int, cluster: int
                        ) -> Optional[Tuple[int, int, int, int]]:
    """The wide loop backward's rows of one atom a block [B * C, 3, N, D]
    (ns, u_pre, key: the forward pass's context reads the keys, the
    recompute schedule's second pass over an atom past one sub-chunk all
    three), None where N is not wide for #4."""
    return (B * cluster, 3, N, cfm.local_dim) if is_wide_backward(N) else None


def tall_shape_for(cfm: ModelConfig, B: int, M: int, cluster: int, tall: bool
                   ) -> Optional[Tuple[int, int, int]]:
    """The tall loop backward's scratch: each block's GA keys and d(layer
    input) partial [B * C, M, G + D] (the wide backward's too, ``tall`` True
    there); None for the other builds."""
    if not tall:
        return None
    return (B * cluster, M, cfm.global_dim + cfm.local_dim)


def launch_loop_forward(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                        cfm: ModelConfig, mrelu_head: bool = False,
                        dropout_rate: float = 0.0, seed: int = 0, mol_base: int = 0,
                        cluster: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check CUDA inputs and launch the kernel with ``pack_params`` output,
    at ``cluster`` blocks per structure (``forward_cluster`` when None), in
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
launch_loop_forward.d256_launches = 0


def _launch(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
            cfm: ModelConfig, mrelu_head: bool, dropout_rate: float = 0.0,
            seed: int = 0, mol_base: int = 0, cluster: Optional[int] = None,
            scratch: Optional[Dict[str, Optional[torch.Tensor]]] = None, tall: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch itself, on inputs ``launch_loop_forward`` accepted, at
    ``cluster`` blocks per structure (``forward_cluster`` when None), on
    ``scratch`` from ``loop_forward_scratch`` (allocated here when None; one
    of another build raises), in the tall build where ``is_tall`` or
    ``tall`` (True forces it at a shape the narrow build takes, with the
    tall plan, for the checks that hold the two builds against each
    other)."""
    dev = packed["wde"].device
    B, M = inputs["atomic"].shape[:2]
    N = inputs["neighbors"].shape[2]
    seg, S = segment_arguments(inputs)
    library, symbol = forward_library(cfm, M, N, S, tall)
    wide = is_wide_forward(cfm, N)
    tall = not wide and (tall or is_tall(cfm, M, N, S))
    sizes = FORWARD_CLUSTER_SIZES if tall or wide else CLUSTER_SIZES
    if cluster is None:
        cluster = forward_cluster(cfm, B, M, N, S, tall)
    if cluster not in sizes:
        raise ValueError(f"cluster={cluster}: the {library} build of the loop forward launches "
                         f"with {sizes}")
    want = loop_forward_scratch(cfm, B, M, N, "meta", cluster, S, tall)
    if scratch is None:
        scratch = loop_forward_scratch(cfm, B, M, N, dev, cluster, S, tall)
    elif any(wide_keys_shape(scratch.get(k)) != wide_keys_shape(want[k])
             for k in ("geo", "next_centers", "readout", "wide_keys")):
        raise ValueError(f"scratch of shape {wide_keys_shape(scratch['next_centers'])} "
                         f"(readout {wide_keys_shape(scratch.get('readout'))}, wide keys "
                         f"{wide_keys_shape(scratch.get('wide_keys'))}) handed to a batch of "
                         f"shape {(B, M, cfm.local_dim)} at {cluster} blocks per structure in "
                         f"the {library} build")
    rows, keys = scratch["readout"], scratch["wide_keys"]
    if keys is not None and keys.data_ptr() != rows.data_ptr() + 4 * rows.numel():
        raise ValueError("the wide keys of a kept scratch must follow its readout rows in "
                         "one allocation (loop_forward_scratch)")
    bf16 = kfwd.operand_mode(cfm)
    chunk_atoms, atom_block, work, _ = forward_plan(cfm, M, N, S, tall)
    tensors, dims, scalars, rng, pred, ga = kfwd.launch_arguments(
        packed, inputs, cfm, mrelu_head, dropout_rate, seed, mol_base, chunk_atoms, work,
        scratch["geo"])
    kfwd.call_kernel(library, symbol, dev, tensors + [scratch["next_centers"], seg, rows],
                     dims + [atom_block, S, bf16, cluster], scalars, rng)
    launch_loop_forward.launches += 1
    launch_loop_forward.bf16_launches += bf16
    launch_loop_forward.wide_launches += wide
    launch_loop_forward.tall_launches += tall
    launch_loop_forward.d256_launches += kfwd.is_d256(cfm)
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


def max_active_forward_clusters(cfm: ModelConfig, B: int, M: int, N: int, cluster: int,
                                S: int = 0, tall: bool = False) -> int:
    """How many clusters of ``cluster`` loop-forward blocks at this shape the
    card runs at once (``cudaOccupancyMaxActiveClusters``), in the kernel of
    the build and operand mode that launches (M, N, S) (``forward_library``,
    ``kfwd.operand_mode``; ``tall`` forces the tall build). Each entry
    point's answers are kept, so a launch asks the card once a shape."""
    import ctypes

    from scann_tpu_torch.kernels._build import load_library

    chunk_atoms, atom_block, work, _ = forward_plan(cfm, M, N, S, tall)
    dims = [B, M, N, cfm.local_dim, cfm.num_head, cfm.embedding_dim, cfm.num_gaussian,
            cfm.global_dim, cfm.dense_out, cfm.n_attention, kfwd.CGCNN_FEATURES,
            int(cfm.feature == "cgcnn"), int(cfm.use_ring), int(cfm.g_update), 0, 0,
            chunk_atoms, work, 0, 0, atom_block, S, kfwd.operand_mode(cfm), cluster]
    library, symbol = forward_library(cfm, M, N, S, tall)
    fn = getattr(load_library(library), symbol + "_max_clusters")
    known = getattr(fn, "answers", None)
    if known is None:
        known = fn.answers = {}
    key = (tuple(dims), cluster)
    if key not in known:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        n = fn((ctypes.c_int * len(dims))(*dims), cluster)
        if n < 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with CUDA error {-n}")
        known[key] = n
    return known[key]


def forward_cluster(cfm: ModelConfig, B: int, M: int, N: int, S: int = 0,
                    tall: bool = False) -> int:
    """Thread blocks per structure of a loop-forward launch: in the tall and
    wide builds (``tall`` forces the tall one) the largest of
    ``FORWARD_CLUSTER_SIZES`` whose B clusters the card runs at once by that
    build's own ``max_active_forward_clusters`` (16 for one structure; 7 at
    B = 16 on a card that runs 15 clusters of 8 and 16 of 7), so a small
    batch fills the card; in the narrow build ``cluster_size(B)``, as the
    loop backward."""
    if not (tall or is_wide_forward(cfm, N) or is_tall(cfm, M, N, S)):
        return cluster_size(B)
    for C in FORWARD_CLUSTER_SIZES:
        if B <= max_active_forward_clusters(cfm, B, M, N, C, S, tall):
            return C
    return 1


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
    walks one atom at a time in sub-chunks of ``WIDE_CHUNK_ROWS`` rows,
    beside the atom's attention and d attention [N, H], without the
    resident buffer. Past 128 columns (``kfwd.is_d256``) the tall chunk is
    the first of ``kfwd.CHUNK_ROWS`` rows whose plan fits at some block,
    and the wide sub-chunk the first of ``D256_WIDE_CHUNK_ROWS`` (64 rows
    with blocks of 8 atoms or more, else 32; where none does, the first's
    plan at the smallest block); ``wide_sub_chunk`` names the wide one.
    ``backward_plan`` is the plan of the build a launch takes."""
    return _backward_plan(cfm, M, N, S, tall)[:3]


def _backward_plan(cfm: ModelConfig, M: int, N: int, S: int, tall: bool
                   ) -> Tuple[int, int, int, int]:
    """``loop_backward_memory_plan`` with the rows of a chunk (of a wide
    sub-chunk) after it."""
    r4 = lambda x: -(-x // 4) * 4
    D, G, O, H = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.num_head
    wd = max(D, G)
    lde = r4(cfm.embedding_dim + (10 if cfm.use_ring else 0))
    ldf = r4(kbwd.CGCNN_FEATURES) if cfm.feature == "cgcnn" else 0
    wide = is_wide_backward(N)
    d256 = kfwd.is_d256(cfm)
    if wide:
        caps = D256_WIDE_CHUNK_ROWS if d256 else (WIDE_CHUNK_ROWS,)
    elif tall:
        caps = kfwd.CHUNK_ROWS if d256 else (TALL_CHUNK_ROWS,)
    else:
        caps = (kbwd.MAX_CHUNK_ROWS,)
    first = None
    for cap in caps:
        blocks = ATOM_BLOCKS
        if wide and not (d256 and cap == WIDE_CHUNK_ROWS):
            blocks = WIDE_BACKWARD_ATOM_BLOCKS   # 64 rows past 128 columns: 8 atoms or more
        for block in blocks:
            block = min(block, M)
            chunk_atoms = max(1, min(block, cap // max(N, 1)))
            if wide:   # a sub-chunk, the atom's attention and d attention [N, H], the d query sum
                rows = cap
                chunk = (rows * (2 * D + 4) + 3 * rows * (D + 4) + 2 * r4(N * H)
                         + r4(rows * H) + wd)
            else:
                rows = chunk_atoms * N
                chunk = kbwd.chunk_floats(rows, D, H)
            work = max(chunk,
                       5 * block * wd + r4(block),
                       block * (2 * lde + ldf) + block * wd,
                       block * wd + 4 * wd + 5 * r4(M) + 3 * r4(O) + 4)   # the readout
            if S:
                work = max(work, block * wd + seg_backward_floats(S, wd, M, O))
            floats = ((0 if tall or wide else M * wd) + 5 * block * wd + work
                      + kbwd.N_WARPS * 2 * wd + 2 * wd)
            if 4 * floats <= MAX_SHARED_BYTES:
                return chunk_atoms, block, 4 * floats, rows
        first = first or (chunk_atoms, block, 4 * floats, rows)
    return first


def wide_sub_chunk(cfm: ModelConfig, M: int, N: int, S: int = 0) -> int:
    """Rows of the wide loop backward's sub-chunk at (config, M, N, S):
    ``WIDE_CHUNK_ROWS`` up to 128 columns, past them the first of
    ``D256_WIDE_CHUNK_ROWS`` whose plan fits (``build_plan`` of the CUDA
    source)."""
    return _backward_plan(cfm, M, N, S, False)[3]


def is_tall_backward(cfm: ModelConfig, M: int, N: int, S: int = 0) -> bool:
    """Whether the loop backward takes (config, M, N, S) in its tall build
    (``csrc/scann_loop_backward_tall.cu``): a narrow N (not
    ``is_wide_backward``) whose narrow plan does not fit a block's shared
    memory; past 128 columns every narrow N (the narrow build has no build
    of widths past 128: ``scann_loop_backward_tall_d256.cu`` takes them)."""
    return not is_wide_backward(N) and (
        kfwd.is_d256(cfm) or loop_backward_memory_plan(cfm, M, N, S)[2] > MAX_SHARED_BYTES)


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


def backward_cluster(cfm: ModelConfig, B: int, M: int, N: int, S: int = 0) -> int:
    """Thread blocks per structure of a loop-backward launch: past 128
    columns (the *_d256 builds) the largest of ``D256_CLUSTER_SIZES`` whose
    B clusters the card runs at once by that build's own
    ``max_active_clusters`` (8 for up to 15 structures, 6 at B = 16, 2 at
    64), so a small batch fills the card; up to 128 columns
    ``cluster_size(B)``, as before."""
    if not kfwd.is_d256(cfm):
        return cluster_size(B)
    for C in D256_CLUSTER_SIZES:
        if B <= max_active_clusters(cfm, B, M, N, C, S):
            return C
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
    reason = (kbwd.dtype_refusal(cfm)
              or kfwd.common_refusal(cfm, N, MAX_NEIGHBORS)
              or segment_refusal(S))
    if reason:
        return reason
    homes = is_tall_backward(cfm, M, N, S) or is_wide_backward(N)
    nbytes = backward_plan(cfm, M, N, S)[2]
    if nbytes > MAX_SHARED_BYTES:
        reason = (f"M={M} atoms" + (f", S={S} segments" if S else "") + ": "
                  + ("one atom block and the readout's vectors" if homes
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
    ``cluster`` defaults to ``backward_cluster``'s), plus the [B, M, D]
    d(layer output), the selective stash of ``stash`` (``loop_stash_mode``'s by
    default) and, for the tall build (``tall``, ``is_tall_backward`` by
    default) and the wide build, each block's GA keys and d(layer input)
    partial ``tall`` [B * C, M, G + D]; in the wide build each block's rows
    of one atom ``wide_rows`` [B * C, 3, N, D] (``wide_rows_shape_for``)
    follow it in the same allocation (the kernel takes one pointer). A
    trainer allocates it once per shape."""
    tall = is_tall_backward(cfm, M, N, S) if tall is None else tall
    cluster = backward_cluster(cfm, B, M, N, S) if cluster is None else cluster
    wide = is_wide_backward(N)
    dev = packed["wde"].device
    scratch = kbwd.allocate_scratch(packed, cfm, B, M, N, cfm.n_attention + 1, cluster)
    scratch["dcenters"] = torch.empty((B, M, cfm.local_dim), device=dev, dtype=torch.float32)
    homes = tall_shape_for(cfm, B, M, cluster, tall or wide)
    rows = wide_rows_shape_for(cfm, B, N, cluster)
    scratch["tall"] = scratch["wide_rows"] = None
    if homes is not None:
        n_homes = math.prod(homes)
        buf = torch.empty(n_homes + (math.prod(rows) if rows else 0), device=dev,
                          dtype=torch.float32)
        scratch["tall"] = buf[:n_homes].view(homes)
        if rows is not None:
            scratch["wide_rows"] = buf[n_homes:].view(rows)
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
    raises); ``cluster`` blocks per structure (1, 2 or 4, up to 8 past 128
    columns; ``backward_cluster``'s when None). The build is
    ``backward_library``'s, the schedule ``loop_stash_mode``'s. Returns
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
    sizes = D256_CLUSTER_SIZES if kfwd.is_d256(cfm) else CLUSTER_SIZES
    cluster = backward_cluster(cfm, B, M, N, S) if cluster is None else cluster
    if cluster not in sizes:
        raise ValueError(f"cluster={cluster}: the loop backward launches with {sizes}")
    name = backward_library(cfm, M, N, S, tall)
    tall = name.startswith("scann_loop_backward_tall")
    wide = is_wide_backward(N)
    chunk_atoms, atom_block, _ = backward_plan(cfm, M, N, S, tall)
    if scratch is None:
        scratch = loop_backward_scratch(packed, cfm, B, M, N, cluster, mode, S, tall)
    elif (scratch["dcenters"].shape != (B, M, cfm.local_dim)
          or scratch["rows"].shape[0] != B * cluster or scratch_stash_mode(scratch) != mode
          or wide_keys_shape(scratch.get("wide_rows")) != wide_rows_shape_for(cfm, B, N, cluster)
          or wide_keys_shape(scratch.get("tall"))
          != tall_shape_for(cfm, B, M, cluster, tall or wide)
          or (wide and not _rows_follow(scratch))):
        raise ValueError(f"scratch of shape {tuple(scratch['dcenters'].shape)} with "
                         f"{scratch['rows'].shape[0]} gradient rows, stash "
                         f"{scratch_stash_mode(scratch)}, tall scratch "
                         f"{wide_keys_shape(scratch.get('tall'))} and wide rows "
                         f"{wide_keys_shape(scratch.get('wide_rows'))} handed to a batch of shape "
                         f"{(B, M, cfm.local_dim)} at {cluster} blocks per structure, stash "
                         f"{mode}, in the {name} build")
    tensors, dims, scalars, rng, offsets, flat, pred = kbwd.launch_arguments(
        packed, inputs, cfm, ct, ct_ga, one_shot, mrelu_head, dropout_rate, seed, mol_base,
        chunk_atoms, scratch)
    kfwd.call_kernel(name, name, packed["wde"].device,
                     tensors + [scratch["dcenters"], seg, scratch["stash_rows"],
                                scratch["stash_attn"], scratch["stash_o1"], scratch["tall"]],
                     dims + [atom_block, S, cluster, kbwd.stash_element_bytes(mode)], scalars,
                     rng, offsets, flat)
    kbwd.count_launch(launch_loop_backward, cfm, mode)
    launch_loop_backward.wide_launches += wide
    launch_loop_backward.tall_launches += tall
    launch_loop_backward.d256_launches += kfwd.is_d256(cfm)
    return flat, pred


def _rows_follow(scratch: Dict[str, Optional[torch.Tensor]]) -> bool:
    """Whether a wide scratch's rows of one atom start where its ``tall``
    scratch ends (the wide build reads both from the ``tall`` pointer)."""
    homes, rows = scratch["tall"], scratch["wide_rows"]
    return (homes.is_contiguous() and rows.is_contiguous()
            and rows.data_ptr() == homes.data_ptr() + 4 * homes.numel())


def max_active_clusters(cfm: ModelConfig, B: int, M: int, N: int, cluster: int,
                        S: int = 0) -> int:
    """How many clusters of ``cluster`` loop-backward blocks at this shape the
    card runs at once (``cudaOccupancyMaxActiveClusters``); a launch of more
    than that many structures takes more than one wave. The kernel of the
    build that launches (M, N, S) in the config's operand mode answers
    (``backward_library``; every build exports its own), and each entry
    point keeps its answers, so a launch asks the card once a shape."""
    import ctypes

    from scann_tpu_torch.kernels._build import load_library

    chunk_atoms, atom_block, _ = backward_plan(cfm, M, N, S)
    dims = [B, M, N, cfm.local_dim, cfm.num_head, cfm.embedding_dim, cfm.num_gaussian,
            cfm.global_dim, cfm.dense_out, cfm.n_attention, kbwd.CGCNN_FEATURES, 0,
            int(cfm.feature == "cgcnn"), int(cfm.use_ring), 0, 0, 0, 0, chunk_atoms, 0, 0,
            atom_block, S, cluster]
    name = backward_library(cfm, M, N, S)
    fn = getattr(load_library(name), name + "_max_clusters")
    known = getattr(fn, "answers", None)
    if known is None:
        known = fn.answers = {}
    key = (tuple(dims), cluster)
    if key not in known:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        n = fn((ctypes.c_int * len(dims))(*dims), cluster)
        if n < 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with CUDA error {-n}")
        known[key] = n
    return known[key]


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
    from the rounded attention and keys in the forward pass. At a wide N
    the reverse walk forms the rows once too (its second pass over an atom
    keeps or stages the first pass's rows).
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
        per_layer += rows                                          # (atom, neighbour) rows
        per_layer += 2 * R * D                                     # energies
    f += cfm.n_attention * per_layer
    f += mm(M, E + (10 if cfm.use_ring else 0), D)                 # embedding
    if cfm.feature == "cgcnn":
        f += mm(M, kbwd.CGCNN_FEATURES, E)
    if cfm.g_update:
        f += 2 * mm(R, K, D)                                       # geometry embedding
    return B * f
