"""One LocalAttention layer on the GPU: the wrapper around
``csrc/local_attention.cu``.

Replaces ``scann_tpu/kernels/local_attention.py:_kernel`` (the Pallas TPU
kernel that fuses one layer: neighbour gather, SCANN+ geometry update or
SCANN distance filter, key and query projections, per-head masked softmax
over the neighbours, masked context sum, + query, LayerNorm). The per-layer
model (``models.scann.scann_forward(..., use_pallas=True)``) calls it once
per layer for what the whole-model kernels refuse: structures beyond the
loop kernel's shared-memory plan, and ``use_attn_norm=False``.

- ``fused_local_attention(centers, neighbor_idx, geometry, neighbor_mask,
  neighbor_weight, params, num_head, scale, g_update)`` keeps the JAX
  signature and layout, with ``params`` the layer's flat dict
  (``filter_geo/kernel``, ``key/bias``, ``layer_norm/scale``, ...): (out
  [B, M, D], geometry out, attn [B, M, N, H]), f32; for SCANN the geometry
  out is the input [B, M, N, K] itself. It is differentiable: the forward
  launches the kernel for CUDA tensors (or raises) and runs the plain
  version for CPU tensors; the backward recomputes the plain layer under
  autograd, as the JAX package's VJP does (it has no backward kernel here).
  ``fused_local_attention.launches`` counts kernel launches
  (``.bf16_launches`` those on bfloat16 tensors, ``.wide_launches`` those
  of the wide build, ``.d256_launches`` those of D past 128 up to 256,
  ``.d512_launches`` those of D past 256).
- ``reference_local_attention`` is the plain layer in the tensors' own
  dtypes (the flax model's layer: in the bf16 model its products and
  elementwise ops round as the tensors do), with the attention dropout of
  ``use_drop`` when it is handed a mask. ``reference_layer_kernel`` is the
  kernel's plain version: the plain layer in f32 on the inputs, its outputs
  in the centers' dtype, as the TPU kernel computes on bfloat16 inputs
  (``local_attention.py:139-205``: f32 inside, bfloat16 stores). The two are
  one function on f32 tensors.
- Element types: the kernel takes all-f32 or all-bfloat16 tensors
  (the bf16 model's first layer) and stores its outputs in that type. Where
  the centers are f32 and other tensors bfloat16 (the bf16 model's later
  layers, whose centers come out of an f32 LayerNorm), those are converted
  to f32, exactly, and the f32 kernel runs, as the TPU kernel computes
  there; bfloat16 centers with an f32 tensor are refused.
- The kernel reads the previous layer's centers from global memory and tiles
  the atoms over the grid, so M is not limited. Its tiles limit the rest: D
  a multiple of 4 up to 512 (``MAX_WIDTH``; past 128 the builds of
  ``csrc/local_attention_d256.cu`` and ``local_attention_wide_d256.cu``, 8
  values of a row a lane in the warp LayerNorms, the narrow one with atom
  blocks down to 8; past 256 those of
  ``local_attention_d512.cu`` and ``local_attention_wide_d512.cu``, 16
  values a lane, chunks and sub-chunks of 16 rows, so the narrow one takes
  N <= 16 with atom blocks down to 4: the width class, ``kernels.widths``)
  and divisible by the heads, N <=
  256, the SCANN filter's input K <= D, float32 or bfloat16. Up to N = 64
  one atom's neighbours fit a chunk of 64 rows (``csrc/local_attention.cu``); a wider
  list launches the wide build (``csrc/local_attention_wide.cu``, built at
  its first launch): one atom at a time, its rows in sub-chunks of 64, the
  softmax over all N from an energy row in shared memory (``wide_softmax``
  of ``csrc/scann_mma.cuh``) and the context from the atom's keys, kept in
  shared memory where ``wide_block_plan`` holds them (f32), else in a
  per-block scratch [blocks, N, D] the wrapper allocates (bf16: always,
  since the L1 the smallest layout leaves holds the bf16 weights). Past 128
  columns both builds run their products in the 32-column layout on the
  layer's packed TF32 planes (``layer_planes``, pointer 19), the narrow one
  in chunks of 32 rows and the wide one in sub-chunks of 32 (16 past 256
  columns), each in two operand buffers where they fit, the next staged
  while one runs.
- It runs its row products on the tensor cores (split-TF32 ``mma.sync``, f32
  accuracy) through the chunk code of ``csrc/scann_forward_common.cuh`` that
  the whole-model forwards share. ``make_plan`` mirrors the launch plan of
  the CUDA source (which refuses any other), one block per SM: the narrow
  build's atom block of ``ATOM_BLOCKS`` with the fewest atoms per SM over
  the card's SMs, the wide build's of ``WIDE_ATOM_BLOCKS`` whose waves cost
  least, counting each block's head.

Bound: ``layer_flops`` (~2.0e10 at one MP2018 layer, B=64, M=96, N=32,
D=128) against one read and one write of the [B, M, N, D] geometry; bound by
operations on an H100: ~0.12 ms with the products as three TF32 passes at its
dense 495 TFLOP/s and ``layer_fp32_flops`` (energies and context) at 67
TFLOP/s FP32.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from scann_tpu_torch.kernels import widths
from scann_tpu_torch.kernels.widths import MAX_WIDTH, NARROW_WIDTH
from scann_tpu_torch.ops.activations import swish
from scann_tpu_torch.ops.attention import gather_neighbor_states, local_attention_core, matmul

REPLACES = "scann_tpu/kernels/local_attention.py:49"  # _kernel
SOURCE = "scann_tpu_torch/csrc/local_attention.cu"
MAX_CHUNK_ROWS = 64
MAX_NEIGHBORS = 256   # the wide builds' limit (csrc/scann_mma.cuh kWideMaxN)
MAX_SHARED_BYTES = 232448  # 227 KB per block on sm_90
# the narrow build's atom blocks up to 128 columns; past it those of the
# width class (``widths.class_of(D).atom_blocks``), in chunks of at most its
# ``chunk_rows`` rows (an atom of more N alone), two operand buffers where
# they fit (d256_block_plan)
ATOM_BLOCKS = widths.CLASSES[0].atom_blocks
WIDE_ATOM_BLOCKS = (16, 8, 4, 2, 1)
WIDE_ATOM_COST, WIDE_HEAD_COST = 20, 3   # the wide plan's cost of a wave: 20 AB + 3
PARAM_KEYS = ("filter_geo/kernel", "filter_geo/bias", "key/kernel", "key/bias",
              "query/kernel", "query/bias", "layer_norm/scale", "layer_norm/bias",
              "layer_norm_g/scale", "layer_norm_g/bias")

Params = Dict[str, torch.Tensor]


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with the reference's eps of 1e-6."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def reference_local_attention(centers: torch.Tensor, neighbor_idx: torch.Tensor,
                              geometry: torch.Tensor, neighbor_mask: torch.Tensor,
                              neighbor_weight: Optional[torch.Tensor], params: Params,
                              num_head: int, scale: float, g_update: bool,
                              attn_mask: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """The plain layer -> (out [B, M, D], geometry out or None for SCANN,
    attn [B, M, N, H] before dropout). SCANN+ updates the geometry from
    [center | geometry | neighbour] as three partial products; SCANN filters
    the distance RBF and scales it by the solid angle. ``attn_mask``
    [B, M, N, H] (0 or 1/keep) is the attention dropout of ``use_drop``."""
    D = centers.shape[-1]
    ns = gather_neighbor_states(centers, neighbor_idx)
    w, b = params["filter_geo/kernel"], params["filter_geo/bias"]
    if g_update:
        u = (matmul(centers, w[0:D])[:, :, None, :]
             + matmul(geometry, w[D:2 * D])
             + matmul(ns, w[2 * D:3 * D])
             + b)
        geometry = layer_norm(swish(u) + geometry, params["layer_norm_g/scale"],
                               params["layer_norm_g/bias"])
        geo_out = geometry
    else:
        geometry = swish(matmul(geometry, w) + b) * neighbor_weight[..., None]
        geo_out = None
    key = matmul(ns * geometry, params["key/kernel"]) + params["key/bias"]
    query = matmul(centers, params["query/kernel"]) + params["query/bias"]
    attn, ctx = local_attention_core(
        query, key, key, neighbor_mask, num_head=num_head, scale=scale,
        dropout_mask=None if attn_mask is None else attn_mask.permute(0, 3, 1, 2))
    out = layer_norm(ctx + query, params["layer_norm/scale"], params["layer_norm/bias"])
    return out, geo_out, attn.permute(0, 2, 3, 1)


def reference_layer_kernel(centers: torch.Tensor, neighbor_idx: torch.Tensor,
                           geometry: torch.Tensor, neighbor_mask: torch.Tensor,
                           neighbor_weight: Optional[torch.Tensor], params: Params,
                           num_head: int, scale: float, g_update: bool
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """The kernel's plain version: ``reference_local_attention`` in f32 on
    the inputs (a bfloat16 value is exact in f32), outputs in the centers'
    dtype."""
    dt = centers.dtype
    f32 = lambda t: t if t is None else t.float()
    out, geo_out, attn = reference_local_attention(
        f32(centers), neighbor_idx, f32(geometry), f32(neighbor_mask), f32(neighbor_weight),
        {k: v.float() for k, v in params.items()}, num_head, scale, g_update)
    return out.to(dt), None if geo_out is None else geo_out.to(dt), attn.to(dt)


def index_bounds(*arrays) -> list:
    """[min, max] of each array, flattened into one list: numpy arrays are
    read on the host, tensors with one read-back (a wait on their device)."""
    if all(isinstance(a, np.ndarray) for a in arrays):
        return [int(v) for a in arrays for v in ((a.min(), a.max()) if a.size else (0, 0))]
    return torch.stack([v for a in arrays for v in (a.min(), a.max())]).cpu().tolist()


def check_neighbor_range(lo: int, hi: int, M: int) -> None:
    """Refuse neighbour indices outside [0, M): on the card an out-of-range
    index is an out-of-bounds read (the TPU's one-hot compare made it a
    silent zero row)."""
    if lo < 0 or hi >= M:
        raise ValueError(f"neighbor indices span [{lo}, {hi}], outside [0, M={M})")


KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def check_supported(D: int, N: int, K: int, num_head: int, dtype: torch.dtype) -> None:
    """Raise NotImplementedError for what the kernel does not take."""
    if dtype not in KERNEL_DTYPES:
        raise NotImplementedError(f"dtype {dtype}: the kernel takes float32 or bfloat16 "
                                  "tensors")
    if (D % 4 or D > MAX_WIDTH or D % num_head or N < 1 or N > MAX_NEIGHBORS
            or K < 1 or K > D):
        raise NotImplementedError(
            f"sizes outside the kernel's tiles: D={D} (multiple of 4, <= {MAX_WIDTH}, "
            f"divisible by num_head={num_head}), N={N} (<= {MAX_NEIGHBORS}), filter "
            f"input K={K} (<= D)")


def narrow_max_n(D: int) -> int:
    """The largest N of #5's narrow build at width D: an atom's list within a
    chunk of rows (the width class's ``narrow_max_n``, kNarrowMaxN of the
    CUDA source: 64, past 256 columns 16)."""
    return widths.class_of(D).narrow_max_n


def is_wide(N: int, D: int) -> bool:
    """Whether N neighbours of width D take #5's wide build (more than
    ``narrow_max_n``; #3's rule is ``scann_loop.is_wide_forward``, the same
    answer up to 128 columns)."""
    return N > narrow_max_n(D)


def library(N: int, D: int) -> str:
    """The build that takes N neighbours of width D, the name of its library
    and its entry points' prefix: ``local_attention_wide`` where ``is_wide``,
    else ``local_attention``; with the width class's suffix
    (``_d256`` past ``NARROW_WIDTH``, ``_d512`` past 256)."""
    name = "local_attention_wide" if is_wide(N, D) else "local_attention"
    return name + widths.class_of(D).suffix


def block_plan(atom_block: int, N: int, D: int, H: int, g_update: bool) -> Tuple[int, int]:
    """(atoms per chunk, shared bytes) of one block of ``atom_block`` atoms of
    the narrow build (N <= 64) -- ``plan_for`` of the CUDA source. A block
    holds the queries and, for SCANN+, cw of its atoms [AB, D + 4] each, and a
    work region for the atoms' centers [AB, D + 4] or a chunk's buffers (rows
    of 2D + 4 and D + 4 floats and the attention [rows, H], rows = atoms per
    chunk x N <= 64)."""
    chunk_atoms = min(atom_block, max(1, MAX_CHUNK_ROWS // N))
    rows = chunk_atoms * N
    chunk = rows * (2 * D + 4) + rows * (D + 4) + -(-rows * H // 4) * 4
    work = max(chunk, atom_block * (D + 4))
    return chunk_atoms, 4 * ((2 if g_update else 1) * atom_block * (D + 4) + work)


def d256_block_plan(atom_block: int, N: int, D: int, H: int, g_update: bool,
                    bf16: bool = False) -> Tuple[int, int, int]:
    """(atoms per chunk, operand buffers, shared bytes) of one block of
    ``atom_block`` atoms of the narrow build past 128 columns --
    ``d256_plan_for`` of the CUDA source. Chunks of at most
    the width class's ``chunk_rows`` rows (32, past 256 columns 16; one
    atom of N rows past that); the slots, the
    front (the block's centers [AB, D + 4] for the head products, then a
    chunk's product [rows, D + 4] and attention [rows, H]) and two operand
    buffers [rows, 2D + 4], with a raw area [rows, 2D] of bfloat16 (rows x D
    floats) on ``bf16`` tensors, so that the next chunk is staged while one
    runs; one buffer where that does not fit."""
    r4 = lambda v: -(-v // 4) * 4
    chunk_atoms = min(atom_block, max(1, widths.class_of(D).chunk_rows // N))
    rows = chunk_atoms * N
    front = max(rows * (D + 4) + r4(rows * H), atom_block * (D + 4))
    slots = (2 if g_update else 1) * atom_block * (D + 4)
    buf = rows * (2 * D + 4)
    two = slots + front + 2 * buf + (rows * D if bf16 else 0)
    if 4 * two <= MAX_SHARED_BYTES:
        return chunk_atoms, 2, 4 * two
    return chunk_atoms, 1, 4 * (slots + front + buf)


def wide_block_plan(atom_block: int, N: int, D: int, H: int, g_update: bool,
                    bf16: bool = False) -> Optional[Tuple[int, bool, int]]:
    """(operand buffers, keys in shared memory, shared bytes) of one block of
    ``atom_block`` atoms of the wide build (N > 64) -- ``wide_block_plan`` of
    the CUDA source (past 128 columns ``wide_d256_block_plan``), or None if
    nothing fits. A block holds the queries and, for SCANN+, cw [AB, D + 4]
    each; the front (the block's centers [AB, D + 4], then a sub-chunk's
    product [rows, D + 4] and the atom's energies [N, H]); one or two operand
    buffers [rows, 2D + 4]; the index ring [2][N] (round4(2N) floats); the
    atom's keys [N, D] where the layout holds them. Up to 128 columns rows =
    64: on f32 tensors the keys where they fit beside one buffer, and a
    second buffer where that fits too; on ``bf16`` tensors one buffer and the
    keys in L2, the smallest layout, whose L1 holds the bf16 weights of the
    row products. Past 128 columns rows = the width class's ``chunk_rows``
    (32; past 256 columns 16) and always two buffers, the keys where they
    fit, with a raw area [rows, 2D] of bfloat16 (rows x D floats) on
    ``bf16`` tensors: the products read the weights' TF32 planes, and this
    layout fits wherever one 64-row buffer fits."""
    r4 = lambda v: -(-v // 4) * 4
    slots = (2 if g_update else 1) * atom_block * (D + 4)
    if D > NARROW_WIDTH:
        rows = widths.class_of(D).chunk_rows
        off_a = max(rows * (D + 4) + r4(N * H), atom_block * (D + 4))
        for smem_keys in (True, False):
            floats = (slots + off_a + 2 * rows * (2 * D + 4) + (rows * D if bf16 else 0)
                      + r4(2 * N) + (N * D if smem_keys else 0))
            if 4 * floats <= MAX_SHARED_BYTES:
                return 2, smem_keys, 4 * floats
        return None
    off_a = max(MAX_CHUNK_ROWS * (D + 4) + r4(N * H), atom_block * (D + 4))
    layouts = ((True, 2), (True, 1), (False, 2), (False, 1))
    for smem_keys, buffers in layouts[3 if bf16 else 0:]:
        floats = (slots + off_a
                  + buffers * MAX_CHUNK_ROWS * (2 * D + 4) + r4(2 * N)
                  + (N * D if smem_keys else 0))
        if 4 * floats <= MAX_SHARED_BYTES:
            return buffers, smem_keys, 4 * floats
    return None


def make_plan(B: int, M: int, N: int, D: int, H: int, g_update: bool,
              n_sm: int, bf16: bool = False) -> Tuple[int, int, int]:
    """(atom block, atoms per chunk, shared bytes per block) of the launch --
    ``make_plan`` and ``make_wide_plan`` of the CUDA source, which refuses
    any other. A block takes a whole SM, so the B * ceil(M / AB) blocks run
    in ceil(blocks / n_sm) waves of AB atoms. The narrow build takes the
    atom block of its width class's ``atom_blocks`` (``ATOM_BLOCKS`` up to
    128 columns, down to 8 atoms past it and to 4 past 256) whose
    ``block_plan`` (past 128 columns ``d256_block_plan``, on f32 or
    ``bf16`` tensors) fits with the fewest atoms per SM, where two tie the
    one with two operand buffers (past 128 columns), then the larger. The
    wide build (one atom a chunk, ``wide_block_plan`` on f32
    or ``bf16`` tensors) takes the atom
    block of ``WIDE_ATOM_BLOCKS`` whose waves cost least, a wave costing
    ``WIDE_ATOM_COST`` x AB + ``WIDE_HEAD_COST`` (a block's head, its
    atoms' cw and query products, costs about 0.15 of an atom's rows; 0.165
    at D = 256 on an NVIDIA H100 80GB HBM3 at 700 W), the smaller where two
    tie."""
    wide = is_wide(N, D)
    best = None
    for ab in WIDE_ATOM_BLOCKS if wide else widths.class_of(D).atom_blocks:
        waves = -(-B * -(-M // ab) // n_sm)
        buffers = 1
        if wide:
            plan = wide_block_plan(ab, N, D, H, g_update, bf16)
            if plan is None:
                continue
            chunk_atoms, nbytes = 1, plan[2]
            cost = waves * (WIDE_ATOM_COST * ab + WIDE_HEAD_COST)
        else:
            if D <= NARROW_WIDTH:
                chunk_atoms, nbytes = block_plan(ab, N, D, H, g_update)
            else:
                chunk_atoms, buffers, nbytes = d256_block_plan(ab, N, D, H, g_update, bf16)
            if nbytes > MAX_SHARED_BYTES:
                continue
            cost = waves * ab
        if (best is None or cost < best[0] or (wide and cost == best[0])
                or (cost == best[0] and buffers > best[1])):
            best = (cost, buffers, ab, chunk_atoms, nbytes)
    if best is None:
        raise NotImplementedError(f"no atom block fits a block's shared memory at N={N}, D={D}")
    return best[2:]


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def launch_local_attention(centers: torch.Tensor, neighbor_idx: torch.Tensor,
                           geometry: torch.Tensor, neighbor_mask: torch.Tensor,
                           neighbor_weight: Optional[torch.Tensor], params: Params,
                           num_head: int, scale: float, g_update: bool
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Check CUDA inputs and launch the kernel -> (out, geometry out or None
    for SCANN, attn), as ``reference_layer_kernel`` returns them. The
    check reads the tensors' metadata only and waits on nothing: the
    neighbour indices are the caller's to check (``check_neighbor_range``;
    the per-layer model's batches are checked where they enter, by
    ``models.scann.check_index_ranges``). The kernel runs in the centers'
    dtype; with f32 centers, bfloat16 tensors are converted to f32 first."""
    dev = centers.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    B, M, D = centers.shape
    N = neighbor_idx.shape[2]
    K = geometry.shape[-1]
    dt = centers.dtype
    check_supported(D, N, K, num_head, dt)
    if dt == torch.float32:
        up = lambda t: t.float() if t is not None and t.dtype == torch.bfloat16 else t
        geometry, neighbor_mask, neighbor_weight = (up(geometry), up(neighbor_mask),
                                                    up(neighbor_weight))
        params = {k: up(v) for k, v in params.items()}
    want = {"centers": (centers, (B, M, D), dt),
            "neighbor_idx": (neighbor_idx, (B, M, N), torch.int32),
            "geometry": (geometry, (B, M, N, D if g_update else K), dt),
            "neighbor_mask": (neighbor_mask, (B, M, N), dt)}
    if not g_update:
        want["neighbor_weight"] = (neighbor_weight, (B, M, N), dt)
    shapes = {"filter_geo/kernel": (3 * D if g_update else K, D), "key/kernel": (D, D),
              "query/kernel": (D, D)}
    for key in PARAM_KEYS[: 10 if g_update else 8]:
        want[key] = (params[key], shapes.get(key, (D,)), dt)
    for name, (t, shape, dtype) in want.items():
        if (t is None or t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            got = "None" if t is None else f"{t.dtype} {tuple(t.shape)} on {t.device}"
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape "
                             f"{shape} on {dev}, got {got}")
    return _launch(centers, neighbor_idx, geometry, neighbor_mask, neighbor_weight, params,
                   num_head, scale, g_update)


def _launch(centers, neighbor_idx, geometry, neighbor_mask, neighbor_weight, params,
            num_head, scale, g_update, outputs=None):
    """The launch itself, on inputs ``launch_local_attention`` accepted;
    ``outputs`` (out, geometry out or None, attn), as it returns them, are
    written in place of new tensors."""
    from scann_tpu_torch.kernels.scann_forward import call_kernel

    dev = centers.device
    B, M, D = centers.shape
    N = neighbor_idx.shape[2]
    K = geometry.shape[-1]
    dt = centers.dtype
    if outputs is None:
        outputs = (torch.empty((B, M, D), device=dev, dtype=dt),
                   torch.empty((B, M, N, D), device=dev, dtype=dt) if g_update else None,
                   torch.empty((B, M, N, num_head), device=dev, dtype=dt))
    out, geo_out, attn = outputs
    tensors = ([centers, neighbor_idx, geometry, neighbor_mask,
                None if g_update else neighbor_weight]
               + [params.get(k) if g_update or "layer_norm_g" not in k else None
                  for k in PARAM_KEYS]
               + [out, geo_out, attn])
    hd = D // num_head
    dk = float(np.float32(hd) ** np.float32(-scale))
    n_sm = sm_count(dev)
    bf16 = int(dt == torch.bfloat16)
    plan = make_plan(B, M, N, D, num_head, g_update, n_sm, bool(bf16))
    lib = library(N, D)
    keys = (torch.empty((B * -(-M // plan[0]), N, D), device=dev, dtype=torch.float32)
            if is_wide(N, D) and not wide_block_plan(plan[0], N, D, num_head, g_update,
                                                     bool(bf16))[1]
            else None)
    # the builds past 128 columns take the packed TF32 planes as pointer 19
    planes = [layer_planes(params, g_update)] if D > NARROW_WIDTH else []
    call_kernel(lib, lib + ("_bf16" if bf16 else ""), dev, tensors + [keys] + planes,
                [B, M, N, D, num_head, K, int(g_update), n_sm, *plan], [dk])
    fused_local_attention.launches += 1
    fused_local_attention.bf16_launches += bf16
    fused_local_attention.wide_launches += is_wide(N, D)
    fused_local_attention.d256_launches += widths.width_class_of(D) == 256
    fused_local_attention.d512_launches += widths.width_class_of(D) == 512
    return out, geo_out, attn


def layer_planes(params: Params, g_update: bool) -> torch.Tensor:
    """``kernels.scann_forward.layer_tf32_planes`` of the layer's Wfg, Wk and
    Wq (f32), which the builds past 128 columns read. Kept on the Wfg
    tensor and made again when any of the three is another tensor or has
    changed in place (its version counter; a tensor made in inference mode
    has none and is split at every launch)."""
    from scann_tpu_torch.kernels.scann_forward import layer_tf32_planes

    ws = [params[k] for k in ("filter_geo/kernel", "key/kernel", "query/kernel")]
    try:
        key = (tuple(w._version for w in ws), g_update)
    except RuntimeError:
        return layer_tf32_planes(*ws, g_update)
    kept = getattr(ws[0], "_scann_tf32_planes", None)
    if kept is not None and kept[0] == key and all(a is b for a, b in zip(kept[1], ws[1:])):
        return kept[2]
    planes = layer_tf32_planes(*ws, g_update)
    ws[0]._scann_tf32_planes = (key, ws[1:], planes)
    return planes


class _FusedLocalAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain layer (CPU). Backward: the
    plain layer recomputed under autograd, differentiated with respect to
    the centers, the geometry, the solid-angle weight and the parameters."""

    @staticmethod
    def forward(ctx, centers, neighbor_idx, geometry, neighbor_mask, neighbor_weight,
                num_head, scale, g_update, keys, *values):
        params = dict(zip(keys, values))
        ctx.save_for_backward(centers, neighbor_idx, geometry, neighbor_mask,
                              neighbor_weight, *values)
        ctx.meta = (num_head, scale, g_update, keys)
        if centers.device.type == "cuda":
            out, geo_out, attn = launch_local_attention(
                centers, neighbor_idx, geometry, neighbor_mask, neighbor_weight, params,
                num_head, scale, g_update)
        elif centers.device.type == "cpu":
            out, geo_out, attn = reference_layer_kernel(
                centers, neighbor_idx, geometry, neighbor_mask, neighbor_weight, params,
                num_head, scale, g_update)
        else:
            raise ValueError(f"unsupported device {centers.device}")
        if not g_update:
            geo_out = geometry.view_as(geometry)      # passthrough: carries its cotangent
        return out, geo_out, attn

    @staticmethod
    def backward(ctx, ct_out, ct_geo, ct_attn):
        centers, neighbor_idx, geometry, neighbor_mask, neighbor_weight, *values = \
            ctx.saved_tensors
        num_head, scale, g_update, keys = ctx.meta
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (centers, geometry, *values)]
            weight = neighbor_weight
            if weight is not None and weight.is_floating_point():
                weight = weight.detach().requires_grad_(True)
            out, geo_out, attn = reference_local_attention(
                leaves[0], neighbor_idx, leaves[1], neighbor_mask, weight,
                dict(zip(keys, leaves[2:])), num_head, scale, g_update)
            if geo_out is None:
                geo_out = leaves[1]
            wrt = leaves + ([weight] if weight is not None else [])
            grads = torch.autograd.grad(
                [out, geo_out, attn], wrt,
                [torch.zeros_like(o) if c is None else c
                 for o, c in ((out, ct_out), (geo_out, ct_geo), (attn, ct_attn))],
                allow_unused=True)
        d_centers, d_geometry, *d_values = grads[: len(leaves)]
        d_weight = grads[-1] if weight is not None else None
        return (d_centers, None, d_geometry, None, d_weight, None, None, None, None,
                *d_values)


def fused_local_attention(centers: torch.Tensor, neighbor_idx: torch.Tensor,
                          geometry: torch.Tensor, neighbor_mask: torch.Tensor,
                          neighbor_weight: Optional[torch.Tensor], params: Params,
                          num_head: int, scale: float, g_update: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused LocalAttention layer -> (out [B, M, D], geometry out
    [B, M, N, *], attn [B, M, N, H]); for SCANN the geometry out is the
    unchanged input. CPU tensors run the plain version
    (``reference_layer_kernel``); CUDA tensors launch the kernel or raise
    (unsupported sizes or dtype, bad input, failed build or launch; neighbour
    indices as ``launch_local_attention`` says)."""
    keys = tuple(k for k in PARAM_KEYS if g_update or "layer_norm_g" not in k)
    return _FusedLocalAttention.apply(centers, neighbor_idx, geometry, neighbor_mask,
                                      neighbor_weight, num_head, scale, g_update, keys,
                                      *[params[k] for k in keys])


fused_local_attention.launches = 0
fused_local_attention.bf16_launches = 0
fused_local_attention.wide_launches = 0
fused_local_attention.d256_launches = 0
fused_local_attention.d512_launches = 0


def layer_flops(B: int, M: int, N: int, D: int, g_update: bool, K: int = 20) -> int:
    """Multiply-add FLOPs (2 per FMA) of one layer, counted from the
    kernel's products; the gather and the elementwise work are left out.
    All but ``layer_fp32_flops`` run on the tensor cores."""
    rows = M * N
    if g_update:
        f = 2 * rows * 3 * D * D + 2 * M * D * D      # [geo | ns] @ Wfg, key; cw
    else:
        f = 2 * rows * K * D + 2 * rows * D * D
    f += 2 * M * D * D                                # query
    f += 2 * rows * D * 2                             # energies, context
    return B * f


def layer_fp32_flops(B: int, M: int, N: int, D: int) -> int:
    """The FLOPs of ``layer_flops`` that run on the CUDA cores in FP32: the
    energies and the context, 2 x B M N D multiply-adds."""
    return B * 2 * M * N * D * 2
