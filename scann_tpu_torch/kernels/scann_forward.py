"""Whole-model SCANN forward on the GPU: the wrapper around
``csrc/scann_forward.cu``.

Replaces ``scann_tpu/kernels/scann_forward.py:_kernel`` (the Pallas TPU
kernel that runs the whole model in one program) for unpacked batches: the
deterministic forward that serving and evaluation run, and the training
forward of ``kernels.scann_backward.scann_apply`` (dropout at a rate above
0, with the Philox masks of ``ops.dropout`` that the backward replays).

- ``fused_scann_forward(params, inputs, cfm, mrelu_head, dropout_rate,
  seed)`` keeps the JAX signature and layout: (property [B, 1], ga_score
  [B, M, 1]), f32. For CUDA tensors it launches the kernel (or raises);
  for CPU tensors it runs the plain version, ``reference_scann_forward``:
  the eager model called functionally, with the same masks.
  ``fused_scann_forward.launches`` counts kernel launches.
- The gate is the kernel's own shared-memory plan (``shared_memory_plan``)
  plus the sizes its tiles take: M <= 64 atoms, chunks of at most 64
  (atom, neighbour) rows (so N <= 64), D, G, O multiples of 4 up to 128.
  Larger structures (crystals) go to the loop kernel (``kernels.scann_loop``).

Bound and design are in the source note of ``csrc/scann_forward.cu``:
about 5.0e10 FLOP of FP32 FMA per QM9 batch (B=128, M=32, N=16, L=7,
D=128), so it is bound by operations (~0.75 ms at the H100 SXM's 67
TFLOP/s FP32 peak); one block per molecule, neighbour gather and per-head
reductions in shared memory, the SCANN+ geometry in a global scratch
buffer.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from scann_tpu_torch.config import ModelConfig, attn_dropout_rate
from scann_tpu_torch.models.scann import scann_forward
from scann_tpu_torch.ops.dropout import (
    DropoutMasks,
    keep_scale,
    keep_threshold,
    make_dropout_masks,
)
from scann_tpu_torch.ops.rbf import make_centers

REPLACES = "scann_tpu/kernels/scann_forward.py:222"  # _kernel
SOURCE = "scann_tpu_torch/csrc/scann_forward.cu"
MAX_ATOMS = 64
MAX_CHUNK_ROWS = 64
MAX_WIDTH = 128
MAX_SHARED_BYTES = 232448  # 227 KB per block on sm_90
RBF_WIDTH = 0.25

_LAYER_KEYS = (
    ("wfg", "local_attention_{}/filter_geo/kernel"),
    ("bfg", "local_attention_{}/filter_geo/bias"),
    ("wk", "local_attention_{}/key/kernel"),
    ("bk", "local_attention_{}/key/bias"),
    ("wq", "local_attention_{}/query/kernel"),
    ("bq", "local_attention_{}/query/bias"),
    ("ln_s", "local_attention_{}/layer_norm/scale"),
    ("ln_b", "local_attention_{}/layer_norm/bias"),
    ("wr1", "residual_norm_{}/dense_1/kernel"),
    ("br1", "residual_norm_{}/dense_1/bias"),
    ("wr2", "residual_norm_{}/dense_2/kernel"),
    ("br2", "residual_norm_{}/dense_2/bias"),
    ("rln_s", "residual_norm_{}/layer_norm/scale"),
    ("rln_b", "residual_norm_{}/layer_norm/bias"),
)


def dropout_masks_for(cfm: ModelConfig, inputs: Dict[str, torch.Tensor], dropout_rate: float,
                      seed: int, mol_base: int = 0) -> Optional[DropoutMasks]:
    """The masks the kernels draw for this batch (None at rate 0)."""
    if dropout_rate <= 0.0:
        return None
    B, M = inputs["atomic"].shape[:2]
    N = inputs["neighbors"].shape[2]
    return make_dropout_masks(seed, mol_base, B, M, N, cfm.local_dim, cfm.num_head,
                              cfm.n_attention, dropout_rate,
                              attn_dropout_rate(cfm, dropout_rate),
                              device=inputs["atomic"].device)


def reference_scann_forward(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                            cfm: ModelConfig, mrelu_head: bool = False,
                            dropout_rate: float = 0.0, seed: int = 0, mol_base: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the eager model, called functionally, with the
    kernels' dropout masks at a rate above 0."""
    return scann_forward(params, inputs, cfm, mrelu_head,
                         dropout_masks_for(cfm, inputs, dropout_rate, seed, mol_base))


def rng_words(cfm: ModelConfig, dropout_rate: float, seed: int, mol_base: int):
    """(flags [dropout, attention dropout], scales [2], words [seed,
    mol_base, threshold, attention threshold]) the kernels take."""
    attn = attn_dropout_rate(cfm, dropout_rate)
    flags = [int(dropout_rate > 0.0), int(attn > 0.0)]
    scales = [keep_scale(dropout_rate) if flags[0] else 1.0,
              keep_scale(attn) if flags[1] else 1.0]
    words = [int(seed) & 0xFFFFFFFF, int(mol_base) & 0xFFFFFFFF,
             keep_threshold(dropout_rate) if flags[0] else 0,
             keep_threshold(attn) if flags[1] else 0]
    return flags, scales, words


def stack_layer_params(params: Dict[str, torch.Tensor], n_layers: int,
                       g_update: bool) -> Dict[str, torch.Tensor]:
    """Per-layer LocalAttention/ResidualNorm params stacked on a leading
    [L] axis (the layout the kernel indexes)."""
    out = {name: torch.stack([params[key.format(i)] for i in range(n_layers)])
           for name, key in _LAYER_KEYS}
    if g_update:
        out["lng_s"] = torch.stack([params[f"local_attention_{i}/layer_norm_g/scale"]
                                    for i in range(n_layers)])
        out["lng_b"] = torch.stack([params[f"local_attention_{i}/layer_norm_g/bias"]
                                    for i in range(n_layers)])
    return out


def shared_memory_plan(cfm: ModelConfig, M: int, N: int) -> Tuple[int, int, int]:
    """(atoms per geometry chunk, floats of the chunk operand buffer, shared
    bytes per block) -- the layout ``make_plan`` in the CUDA source walks."""
    r4 = lambda x: -(-x // 4) * 4
    D, G, O, H = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.num_head
    wd = max(D, G)
    chunk_atoms = max(1, min(M, MAX_CHUNK_ROWS // N))
    rows = chunk_atoms * N
    stage = M * r4(cfm.embedding_dim + (10 if cfm.use_ring else 0))
    if cfm.feature == "cgcnn":
        stage += M * r4(92)
    abuf = max(rows * 2 * D, stage)
    floats = (3 * M * wd + abuf + rows * D + r4(rows * H)
              + 2 * wd + r4(M) + r4(O))
    return chunk_atoms, abuf, 4 * floats


def refusal(cfm: ModelConfig, M: int, N: int) -> Optional[str]:
    """Why the kernel does not take (config, M, N), or None where it does:
    the gate, read by ``check_supported`` and by the dispatch in
    ``Trainer.eval_route``."""
    if M > MAX_ATOMS:
        return (f"M={M} atoms: the whole-model kernel takes M <= {MAX_ATOMS}; "
                "larger structures go to the crystal loop kernel (kernels.scann_loop)")
    if not cfm.use_attn_norm:
        return ("use_attn_norm=False: the kernel always applies ResidualNorm; "
                "that configuration runs in the per-layer model "
                "(models.scann.scann_forward with use_pallas)")
    reason = common_refusal(cfm, N)
    nbytes = 0 if reason else shared_memory_plan(cfm, M, N)[2]
    if nbytes > MAX_SHARED_BYTES:
        reason = f"shared-memory plan of {nbytes} bytes exceeds {MAX_SHARED_BYTES}"
    return reason


def common_refusal(cfm: ModelConfig, N: int) -> Optional[str]:
    """What both whole-model forwards refuse: a dtype other than float32 and
    sizes outside the tiles of ``csrc/scann_common.cuh``."""
    if cfm.dtype != "float32":
        return (f"model.dtype={cfm.dtype!r}: float32 only (the bf16 products of the TPU "
                "kernels are not ported)")
    D, G, O, E = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.embedding_dim
    if (N < 1 or N > MAX_CHUNK_ROWS or any(x % 4 or x > MAX_WIDTH for x in (D, G, O))
            or E % 4 or D % cfm.num_head or cfm.num_gaussian > D):
        return (f"sizes outside the kernel's tiles: N={N} (<= {MAX_CHUNK_ROWS}), "
                f"D={D}, G={G}, O={O} (multiples of 4, <= {MAX_WIDTH}), E={E} "
                f"(multiple of 4), D % num_head == 0, num_gaussian <= D")
    return None


def check_supported(cfm: ModelConfig, M: int, N: int) -> None:
    """Raise NotImplementedError for what the kernel does not take."""
    reason = refusal(cfm, M, N)
    if reason:
        raise NotImplementedError(reason)


def pack_params(params: Dict[str, torch.Tensor], cfm: ModelConfig) -> Dict[str, torch.Tensor]:
    """Everything the kernel reads besides the batch: stacked layer params,
    the other weights, the RBF centers; contiguous f32 on the params' device."""
    dev = params["dense_embed/kernel"].device
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    p = {k: f32(v) for k, v in stack_layer_params(params, cfm.n_attention,
                                                  cfm.g_update).items()}
    if cfm.feature == "cgcnn":
        p["embed"] = f32(params["embed_atom/kernel"])
        p["bembed"] = f32(params["embed_atom/bias"])
    else:
        p["embed"] = f32(params["embed_atom/embedding"])
    if cfm.use_ring:
        p["wring"] = f32(params["extra_embed/kernel"])
        p["bring"] = f32(params["extra_embed/bias"])
    for short, name in (("de", "dense_embed"), ("al", "after_Lc"),
                        ("gq", "global_attention/query"), ("gk", "global_attention/key"),
                        ("bf", "bf_property"), ("p", "predict_property")):
        p[f"w{short}"] = f32(params[f"{name}/kernel"])
        p[f"b{short}"] = f32(params[f"{name}/bias"])
    if cfm.g_update:
        for short, name in (("nd", "neighbor_d"), ("nw", "neighbor_w")):
            p[f"w{short}"] = f32(params[f"{name}/kernel"])
            p[f"b{short}"] = f32(params[f"{name}/bias"])
        p["angle_centers"] = f32(torch.from_numpy(make_centers(2 * np.pi, cfm.num_gaussian)))
    p["dist_centers"] = f32(torch.from_numpy(make_centers(cfm.gaussian_d, cfm.num_gaussian)))
    return p


_INPUT_KEYS = ("atomic", "feat", "atom_mask", "neighbors", "neighbor_mask",
               "neighbor_weight", "neighbor_distance", "ring_aromatic")
_PARAM_KEYS = ("dist_centers", "angle_centers", "embed", "bembed", "wring", "bring",
               "wde", "bde", "wnd", "bnd", "wnw", "bnw",
               "wfg", "bfg", "wk", "bk", "wq", "bq", "ln_s", "ln_b", "lng_s", "lng_b",
               "wr1", "br1", "wr2", "br2", "rln_s", "rln_b",
               "wal", "bal", "wgq", "bgq", "wgk", "bgk", "wbf", "bbf", "wp", "bp")


def _check_inputs(inputs: Dict[str, torch.Tensor], cfm: ModelConfig,
                  dev: torch.device) -> Tuple[int, int, int]:
    cgcnn = cfm.feature == "cgcnn"
    atomic = inputs["atomic"]
    B, M = atomic.shape[:2]
    N = inputs["neighbors"].shape[2]
    want = {
        "atomic": ((B, M, 92) if cgcnn else (B, M), torch.float32 if cgcnn else torch.int32),
        "atom_mask": ((B, M, 1), torch.float32),
        "neighbors": ((B, M, N), torch.int32),
        "neighbor_mask": ((B, M, N), torch.float32),
        "neighbor_weight": ((B, M, N), torch.float32),
        "neighbor_distance": ((B, M, N), torch.float32),
    }
    if cfm.use_ring:
        want["ring_aromatic"] = ((B, M, 2), torch.float32)
    for k, (shape, dtype) in want.items():
        t = inputs[k]
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"input {k!r}: expected a contiguous {dtype} tensor of shape {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    # an out-of-range index is an out-of-bounds read on the GPU (the TPU's
    # one-hot compare made it a silent zero row): refuse it on the host
    nbr = inputs["neighbors"]
    if cgcnn:
        lo_hi = torch.stack([nbr.min(), nbr.max()]).cpu().tolist()
        z_lo, z_hi = 0, 0
    else:
        z_lo, z_hi, *lo_hi = torch.stack(
            [atomic.min(), atomic.max(), nbr.min(), nbr.max()]).cpu().tolist()
        if z_lo < 0 or z_hi >= cfm.n_atoms:
            raise ValueError(f"atomic numbers span [{z_lo}, {z_hi}], outside the "
                             f"embedding vocab [0, {cfm.n_atoms})")
    if lo_hi[0] < 0 or lo_hi[1] >= M:
        raise ValueError(f"neighbor indices span [{lo_hi[0]}, {lo_hi[1]}], outside "
                         f"[0, M={M})")
    return B, M, N


def launch_scann_forward(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                         cfm: ModelConfig, mrelu_head: bool = False,
                         dropout_rate: float = 0.0, seed: int = 0, mol_base: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check CUDA inputs and launch the kernel with ``pack_params`` output."""
    dev = packed["wde"].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    _check_inputs(inputs, cfm, dev)
    return _launch(packed, inputs, cfm, mrelu_head, dropout_rate, seed, mol_base)


def launch_arguments(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                     cfm: ModelConfig, mrelu_head: bool, dropout_rate: float, seed: int,
                     mol_base: int, chunk_atoms: int, abuf: int):
    """What the whole-model forwards (this kernel and the crystal loop
    kernel) are launched with: (tensors in ``unpack_forward_args`` order,
    the outputs and the SCANN+ geometry scratch last; sizes; scalars;
    random-stream words), and the outputs (pred [B], ga [B, M])."""
    dev = packed["wde"].device
    B, M = inputs["atomic"].shape[:2]
    N = inputs["neighbors"].shape[2]
    D = cfm.local_dim
    cgcnn = cfm.feature == "cgcnn"
    pred = torch.empty(B, device=dev, dtype=torch.float32)
    ga = torch.empty((B, M), device=dev, dtype=torch.float32)
    geo = (torch.empty(B * M * N * D, device=dev, dtype=torch.float32)
           if cfm.g_update else None)
    tensors = {
        "atomic": None if cgcnn else inputs["atomic"],
        "feat": inputs["atomic"] if cgcnn else None,
        "atom_mask": inputs["atom_mask"],
        "neighbors": inputs["neighbors"],
        "neighbor_mask": inputs["neighbor_mask"],
        "neighbor_weight": inputs["neighbor_weight"],
        "neighbor_distance": inputs["neighbor_distance"],
        "ring_aromatic": inputs.get("ring_aromatic") if cfm.use_ring else None,
    }
    order = ([tensors[k] for k in _INPUT_KEYS] + [packed.get(k) for k in _PARAM_KEYS]
             + [geo, pred, ga])
    dims = [B, M, N, D, cfm.num_head, cfm.embedding_dim, cfm.num_gaussian,
            cfm.global_dim, cfm.dense_out, cfm.n_attention, 92,
            int(cgcnn), int(cfm.use_ring), int(cfm.g_update), int(cfm.use_ga_norm),
            int(mrelu_head), chunk_atoms, abuf]
    flags, scales, words = rng_words(cfm, dropout_rate, seed, mol_base)
    return order, dims + flags, [attention_scale(cfm), RBF_WIDTH, *scales], words, pred, ga


def call_kernel(library: str, symbol: str, dev: torch.device, tensors, dims, scalars,
                rng=None, offsets=None, out: Optional[torch.Tensor] = None) -> None:
    """Launch ``<symbol>_launch`` of ``csrc/<library>.cu`` on ``dev``'s
    current stream; a launch the card refuses raises RuntimeError. The
    backward kernels also take the gradient ``offsets`` and the tensor
    ``out`` that their row reduction fills."""
    from scann_tpu_torch.kernels._build import load_library

    lib = load_library(library)
    args = [(ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr()
                                                for t in tensors]),
            (ctypes.c_int * len(dims))(*dims), (ctypes.c_float * len(scalars))(*scalars)]
    if rng is not None:
        args.append((ctypes.c_uint32 * len(rng))(*rng))
    if offsets is not None:
        args.append((ctypes.c_longlong * len(offsets))(*offsets))
    if out is not None:
        args.append(ctypes.c_void_p(out.data_ptr()))
    fn = getattr(lib, f"{symbol}_launch")
    fn.argtypes = [ctypes.c_void_p] * (len(args) + 1)
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(*args, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        err = getattr(lib, f"{symbol}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{symbol} kernel launch failed ({rc}): {err(rc).decode()}")


def _launch(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
            cfm: ModelConfig, mrelu_head: bool, dropout_rate: float = 0.0,
            seed: int = 0, mol_base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch itself, on inputs ``_check_inputs`` accepted."""
    B, M = inputs["atomic"].shape[:2]
    N = inputs["neighbors"].shape[2]
    check_supported(cfm, M, N)
    chunk_atoms, abuf, _ = shared_memory_plan(cfm, M, N)
    tensors, dims, scalars, rng, pred, ga = launch_arguments(
        packed, inputs, cfm, mrelu_head, dropout_rate, seed, mol_base, chunk_atoms, abuf)
    call_kernel("scann_forward", "scann_forward", packed["wde"].device, tensors, dims,
                scalars, rng)
    fused_scann_forward.launches += 1
    return pred.view(B, 1), ga.view(B, M, 1)


def fused_scann_forward(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                        cfm: ModelConfig, mrelu_head: bool = False,
                        dropout_rate: float = 0.0, seed: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-model forward -> (property [B, 1], ga_score [B, M, 1]), f32;
    the training forward at ``dropout_rate`` > 0 (masks keyed on ``seed``).

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise (unsupported shape, bad input, failed build or launch)."""
    dev = inputs["atomic"].device
    if dev.type == "cpu":
        return reference_scann_forward(params, inputs, cfm, mrelu_head, dropout_rate, seed)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return launch_scann_forward(pack_params(params, cfm), inputs, cfm, mrelu_head,
                                dropout_rate, seed)


fused_scann_forward.launches = 0


def attention_scale(cfm: ModelConfig) -> float:
    """The query scale hd ** -scale, in float32 as the eager model has it."""
    hd = cfm.local_dim // cfm.num_head
    return float(np.float32(hd) ** np.float32(-cfm.scale))


def forward_flops(cfm: ModelConfig, B: int, M: int, N: int) -> int:
    """Multiply-add FLOPs (2 per FMA) of the forward at one padded batch,
    counted from the kernel's products; the neighbour gather, the RBF
    exponentials and the other elementwise work are left out."""
    D, K, E, G, O = (cfm.local_dim, cfm.num_gaussian, cfm.embedding_dim,
                     cfm.global_dim, cfm.dense_out)
    rows = M * N
    ke = E + (10 if cfm.use_ring else 0)
    f = 2 * M * ke * D + (2 * M * 92 * E if cfm.feature == "cgcnn" else 0)
    if cfm.g_update:
        f += 2 * 2 * rows * K * D                     # neighbor_d, neighbor_w
        per_layer = 2 * rows * 3 * D * D              # [geo | ns] @ Wfg, key
        per_layer += 2 * M * D * D                    # cw
    else:
        per_layer = 2 * rows * K * D + 2 * rows * D * D
    per_layer += 2 * M * D * D                        # query
    per_layer += 2 * rows * D * 2                     # energies, context
    per_layer += 2 * 2 * M * D * D                    # ResidualNorm
    f += cfm.n_attention * per_layer
    f += 2 * M * D * G + 2 * 2 * M * G * G + 6 * M * G + 2 * G * O + 2 * O
    return B * f
