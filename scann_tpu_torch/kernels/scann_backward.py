"""Whole-model SCANN backward on the GPU: the wrapper around
``csrc/scann_backward.cu``.

Replaces ``scann_tpu/kernels/scann_backward.py:_kernel`` (the Pallas TPU
kernel that recomputes the forward and returns every parameter gradient in
one program) for unpacked batches.

- ``fused_scann_grad(params, inputs, cfm, ct_pred, ct_ga, dropout_rate,
  seed)``: the parameter gradients of (pred, ga) contracted with the
  cotangents (ct_pred [B] or [B, 1], ct_ga [B, M] or [B, M, 1]).
- ``fused_scann_train_grads(params, inputs, targets, cfm, mrelu_head,
  dropout_rate, seed)``: the one-shot training step, forward, residual
  and backward in one launch; returns (pred [B, 1], raw gradients of
  0.5 * sum((pred - t)^2)), as ``scann_backward.py:727-749``. mrelu is
  straight-through, so its gate does not enter the gradient.
- ``scann_apply``: a ``torch.autograd.Function`` whose forward is the
  forward kernel and whose backward is this kernel, on the same dropout
  masks (``scann_backward.py:798-837``).

Gradients come back as a flat dict keyed like the params
(``local_attention_3/filter_geo/kernel``, ...); on the GPU they are views
of one [P] vector the reduction kernel wrote. Inputs get no gradient. For
CUDA tensors the wrapper launches the kernel or raises; for CPU tensors it
runs the plain version, ``reference_*``: the eager training forward with
the same Philox masks, differentiated with ``torch.autograd.grad``.
``launch_scann_backward.launches`` counts kernel launches (each launch is
the backward kernel plus its row reduction).

The gate (``refusal``) is the kernel's own shared-memory plan: seven
[M, max(D, G)] buffers stay resident, so M <= 32 at D = G = 128; larger
buckets train through the backward of the crystal loop kernel
(``kernels.scann_loop``). The kernel's products run on the tensor cores as
split-TF32 ``mma.sync`` (``csrc/scann_mma.cuh``: three TF32 passes per tile,
accumulated in f32), which keeps f32 accuracy; ``reference_tf32x3_matmul``
is that arithmetic in plain PyTorch and ``mma_selftest`` runs the header's
three products on the card. Packed batches (``segment_onehot``) raise
NotImplementedError: structure packing is not ported yet. Bound and design are in the source note of
``csrc/scann_backward.cu``; ``backward_flops`` counts the products the
function needs, ``recompute_flops`` those the kernel's schedule adds.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.kernels.scann_forward import (
    MAX_ATOMS,
    MAX_SHARED_BYTES,
    MAX_WIDTH,
    RBF_WIDTH,
    _LAYER_KEYS,
    _check_inputs,
    attention_scale,
    call_kernel,
    dropout_masks_for,
    forward_flops,
    fused_scann_forward,
    pack_params,
    rng_words,
)
from scann_tpu_torch.models.scann import CGCNN_FEATURES, scann_forward

REPLACES = "scann_tpu/kernels/scann_backward.py:77"  # _kernel
SOURCE = "scann_tpu_torch/csrc/scann_backward.cu"
MAX_CHUNK_ROWS = 32
N_WARPS = 8

# the kernel's gradient order (scann_backward.py:90-97), as pack_params names
GRAD_NAMES = ("embed", "bembed", "wring", "bring", "wde", "bde", "wnd", "bnd", "wnw", "bnw",
              "wfg", "bfg", "wk", "bk", "wq", "bq", "ln_s", "ln_b", "lng_s", "lng_b",
              "wr1", "br1", "wr2", "br2", "rln_s", "rln_b",
              "wal", "bal", "wgq", "bgq", "wgk", "bgk", "wbf", "bbf", "wp", "bp")


def param_keys(cfm: ModelConfig) -> Dict[str, str]:
    """pack_params name -> params key; per-layer names map to a template
    with ``{}`` for the layer index."""
    keys = dict(_LAYER_KEYS)
    keys["lng_s"] = "local_attention_{}/layer_norm_g/scale"
    keys["lng_b"] = "local_attention_{}/layer_norm_g/bias"
    if cfm.feature == "cgcnn":
        keys["embed"], keys["bembed"] = "embed_atom/kernel", "embed_atom/bias"
    else:
        keys["embed"] = "embed_atom/embedding"
    for short, name in (("ring", "extra_embed"), ("de", "dense_embed"), ("nd", "neighbor_d"),
                        ("nw", "neighbor_w"), ("al", "after_Lc"),
                        ("gq", "global_attention/query"), ("gk", "global_attention/key"),
                        ("bf", "bf_property"), ("p", "predict_property")):
        keys[f"w{short}"] = f"{name}/kernel"
        keys[f"b{short}"] = f"{name}/bias"
    return keys


def grad_layout(packed: Dict[str, torch.Tensor]) -> Tuple[List[int], int]:
    """Offsets (-1 for a parameter the config does not have) of every
    gradient in one row, each aligned to 4 floats, and the row length P."""
    offsets, P = [], 0
    for name in GRAD_NAMES:
        t = packed.get(name)
        if t is None:
            offsets.append(-1)
            continue
        offsets.append(P)
        P += -(-t.numel() // 4) * 4
    return offsets, P


def grads_from_flat(flat: torch.Tensor, packed: Dict[str, torch.Tensor],
                    cfm: ModelConfig) -> Dict[str, torch.Tensor]:
    """The flat [P] gradient as a dict keyed like the params (views)."""
    offsets, _ = grad_layout(packed)
    keys = param_keys(cfm)
    out = {}
    for name, off in zip(GRAD_NAMES, offsets):
        if off < 0:
            continue
        shape = packed[name].shape
        view = flat[off:off + packed[name].numel()].view(shape)
        if "{}" in keys[name]:
            for l in range(shape[0]):
                out[keys[name].format(l)] = view[l]
        else:
            out[keys[name]] = view
    return out


def chunk_floats(rows: int, D: int, H: int) -> int:
    """Floats of the buffers of one chunk of (atom, neighbour) rows in both
    backward kernels: [rows, 2D + 4] operands, three [rows, D + 4] buffers
    (the strides of 4 mod 32 floats keep the tensor-core fragment reads free
    of bank conflicts) and three [rows, H] attention buffers."""
    r4 = lambda x: -(-x // 4) * 4
    return rows * (2 * D + 4) + 3 * rows * (D + 4) + 3 * r4(rows * H)


def shared_memory_plan(cfm: ModelConfig, M: int, N: int) -> Tuple[int, int]:
    """(atoms per chunk of rows, shared bytes per block): the layout
    ``make_plan`` in the CUDA source walks."""
    r4 = lambda x: -(-x // 4) * 4
    D, G, O, H = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.num_head
    wd = max(D, G)
    MW = M * wd
    chunk_atoms = max(1, min(M, MAX_CHUNK_ROWS // N))
    rows = chunk_atoms * N
    lde = r4(cfm.embedding_dim + (10 if cfm.use_ring else 0))
    ldf = r4(CGCNN_FEATURES) if cfm.feature == "cgcnn" else 0
    work = max(chunk_floats(rows, D, H),
               5 * MW + 4 * wd + 4 * r4(M) + 3 * r4(O) + 4,
               6 * MW + r4(M),
               2 * M * lde + M * ldf + MW)
    floats = 7 * MW + work + N_WARPS * 2 * wd + 2 * wd
    return chunk_atoms, 4 * floats


def refusal(cfm: ModelConfig, M: int, N: int,
            inputs: Optional[Dict[str, torch.Tensor]] = None) -> Optional[str]:
    """Why the backward kernel does not take (config, M, N) or this batch,
    or None where it does: the gate, read by ``check_supported`` and by the
    dispatch in ``Trainer.train_route``."""
    if inputs is not None and ("segment_onehot" in inputs or "segment_mask" in inputs):
        return "packed batches (segment_onehot): structure packing is not ported yet"
    if M > MAX_ATOMS:
        return (f"M={M} atoms: the whole-model backward takes M <= {MAX_ATOMS}; larger "
                "structures train through the backward of the crystal loop kernel "
                "(kernels.scann_loop.loop_scann_train_grads)")
    if not cfm.use_attn_norm:
        return ("use_attn_norm=False: the kernel always applies ResidualNorm; that "
                "configuration trains through the per-layer model")
    if cfm.dtype != "float32":
        return f"model.dtype={cfm.dtype!r}: float32 only"
    D, G, O, E = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.embedding_dim
    if (N < 1 or N > MAX_CHUNK_ROWS or any(x % 4 or x > MAX_WIDTH for x in (D, G, O))
            or E % 4 or D % cfm.num_head or cfm.num_gaussian > D):
        return (f"sizes outside the backward kernel's tiles: N={N} (<= {MAX_CHUNK_ROWS}), "
                f"D={D}, G={G}, O={O} (multiples of 4, <= {MAX_WIDTH}), E={E} "
                f"(multiple of 4), D % num_head == 0, num_gaussian <= D")
    nbytes = shared_memory_plan(cfm, M, N)[1]
    if nbytes > MAX_SHARED_BYTES:
        return (f"M={M}, N={N}: the backward's shared-memory plan of {nbytes} bytes exceeds "
                f"{MAX_SHARED_BYTES}; larger structures train through the backward of the "
                "crystal loop kernel (kernels.scann_loop.loop_scann_train_grads)")
    return None


def check_supported(cfm: ModelConfig, M: int, N: int) -> None:
    """Raise NotImplementedError for what the backward kernel does not take."""
    reason = refusal(cfm, M, N)
    if reason:
        raise NotImplementedError(reason)


def _check_packed_inputs(inputs: Dict[str, torch.Tensor]) -> None:
    if "segment_onehot" in inputs or "segment_mask" in inputs:
        raise NotImplementedError(
            "packed batches (segment_onehot): structure packing is not ported yet")


# --- the plain version -------------------------------------------------------

def _as_rows(x, B: int, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(B, -1)


def reference_fused_scann_grad(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                               cfm: ModelConfig, ct_pred, ct_ga, dropout_rate: float = 0.0,
                               seed: int = 0, mol_base: int = 0) -> Dict[str, torch.Tensor]:
    """Gradients of sum(pred * ct_pred) + sum(ga * ct_ga) through the eager
    training forward (head without mrelu, as the kernel's cotangent path)."""
    B, M = inputs["atomic"].shape[:2]
    dev = inputs["atomic"].device
    ctp = _as_rows(ct_pred, B, dev)[:, :1]
    ctg = _as_rows(ct_ga, B, dev).reshape(B, M, 1)
    masks = dropout_masks_for(cfm, inputs, dropout_rate, seed, mol_base)
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        pred, ga = scann_forward(leaves, inputs, cfm, False, masks)
        loss = (pred * ctp).sum() + (ga * ctg).sum()
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def reference_fused_scann_train_grads(params: Dict[str, torch.Tensor],
                                      inputs: Dict[str, torch.Tensor], targets,
                                      cfm: ModelConfig, mrelu_head: bool = False,
                                      dropout_rate: float = 0.0, seed: int = 0,
                                      mol_base: int = 0
                                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(pred [B, 1], gradients of 0.5 * sum((pred - t)^2)) through the eager
    training forward; mrelu is straight-through."""
    B = inputs["atomic"].shape[0]
    y = _as_rows(targets, B, inputs["atomic"].device)[:, 0]
    masks = dropout_masks_for(cfm, inputs, dropout_rate, seed, mol_base)
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        pred, _ = scann_forward(leaves, inputs, cfm, mrelu_head, masks)
        loss = 0.5 * ((pred[:, 0] - y) ** 2).sum()
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return pred.detach(), dict(zip(leaves, grads))


# --- the kernel --------------------------------------------------------------

def launch_scann_backward(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                          cfm: ModelConfig, ct: torch.Tensor, ct_ga: Optional[torch.Tensor],
                          one_shot: bool, mrelu_head: bool = False, dropout_rate: float = 0.0,
                          seed: int = 0, mol_base: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check CUDA inputs and launch the backward kernel and its reduction
    with ``pack_params`` output. ``ct`` [B] is d pred, or the targets when
    ``one_shot``; ``ct_ga`` [B, M] (ignored when ``one_shot``). Returns
    (flat gradients [P], pred [B])."""
    dev = packed["wde"].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    _check_packed_inputs(inputs)
    _check_inputs(inputs, cfm, dev)
    return _launch(packed, inputs, cfm, ct, ct_ga, one_shot, mrelu_head, dropout_rate, seed,
                   mol_base)


def allocate_scratch(packed: Dict[str, torch.Tensor], cfm: ModelConfig, B: int, M: int, N: int,
                     center_layers: int, blocks: int = 1) -> Dict[str, Optional[torch.Tensor]]:
    """The global scratch of one backward launch at batch shape (B, M, N):
    the stashes of layer inputs (``center_layers`` sets of centers), of
    ctx + query and, for SCANN+, of the geometry and its gradient, and the
    [B * blocks, P] gradient rows, one per CUDA block (``blocks`` per
    structure). Its contents mean nothing between
    launches, so a caller may keep it and hand it to every launch of that
    shape."""
    dev = packed["wde"].device
    L, D, R = cfm.n_attention, cfm.local_dim, M * N
    empty = lambda *shape: torch.empty(shape, device=dev, dtype=torch.float32)
    return {"c_stash": empty(B, center_layers, M, D), "o_stash": empty(B, L, M, D),
            "g_stash": empty(B, L, R, D) if cfm.g_update else None,
            "dgeo": empty(B, R, D) if cfm.g_update else None,
            "rows": empty(B * blocks, grad_layout(packed)[1])}


def launch_arguments(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                     cfm: ModelConfig, ct: torch.Tensor, ct_ga: Optional[torch.Tensor],
                     one_shot: bool, mrelu_head: bool, dropout_rate: float, seed: int,
                     mol_base: int, chunk_atoms: int, scratch: Dict[str, Optional[torch.Tensor]]):
    """What the whole-model backwards (this kernel and the crystal loop
    backward) are launched with: (tensors in ``unpack_backward_args`` order,
    sizes, scalars, random-stream words, gradient offsets with the row
    length last), and the outputs (flat gradients [P], pred [B])."""
    dev = packed["wde"].device
    B, M = inputs["atomic"].shape[:2]
    N = inputs["neighbors"].shape[2]
    cgcnn = cfm.feature == "cgcnn"
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).reshape(B, -1).contiguous()
    ct = f32(ct)[:, 0].contiguous()
    ct_ga = f32(ct_ga) if ct_ga is not None and not one_shot else None
    offsets, P = grad_layout(packed)
    flat = torch.empty(P, device=dev, dtype=torch.float32)
    pred = torch.empty(B, device=dev, dtype=torch.float32)
    tensors = ([None if cgcnn else inputs["atomic"], inputs["atomic"] if cgcnn else None,
                inputs["atom_mask"], inputs["neighbors"], inputs["neighbor_mask"],
                inputs["neighbor_weight"], inputs["neighbor_distance"],
                inputs.get("ring_aromatic") if cfm.use_ring else None,
                packed["dist_centers"], packed.get("angle_centers"), ct, ct_ga]
               + [packed.get(name) for name in GRAD_NAMES]
               + [scratch[k] for k in ("c_stash", "o_stash", "g_stash", "dgeo", "rows")]
               + [pred])
    dims = [B, M, N, cfm.local_dim, cfm.num_head, cfm.embedding_dim, cfm.num_gaussian,
            cfm.global_dim, cfm.dense_out, cfm.n_attention, CGCNN_FEATURES,
            packed["embed"].shape[0], int(cgcnn), int(cfm.use_ring), int(cfm.g_update),
            int(cfm.use_ga_norm), int(mrelu_head), int(one_shot), chunk_atoms]
    flags, scales, words = rng_words(cfm, dropout_rate, seed, mol_base)
    return (tensors, dims + flags, [attention_scale(cfm), RBF_WIDTH, *scales], words,
            offsets + [P], flat, pred)


def _launch(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
            cfm: ModelConfig, ct: torch.Tensor, ct_ga: Optional[torch.Tensor], one_shot: bool,
            mrelu_head: bool = False, dropout_rate: float = 0.0, seed: int = 0,
            mol_base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch itself, on inputs ``_check_inputs`` accepted."""
    B, M = inputs["atomic"].shape[:2]
    N = inputs["neighbors"].shape[2]
    check_supported(cfm, M, N)
    chunk_atoms, _ = shared_memory_plan(cfm, M, N)
    scratch = allocate_scratch(packed, cfm, B, M, N, cfm.n_attention)
    tensors, dims, scalars, rng, offsets, flat, pred = launch_arguments(
        packed, inputs, cfm, ct, ct_ga, one_shot, mrelu_head, dropout_rate, seed, mol_base,
        chunk_atoms, scratch)
    call_kernel("scann_backward", "scann_backward", packed["wde"].device, tensors, dims,
                scalars, rng, offsets, flat)
    launch_scann_backward.launches += 1
    return flat, pred


launch_scann_backward.launches = 0


def fused_scann_grad(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                     cfm: ModelConfig, ct_pred, ct_ga, dropout_rate: float = 0.0,
                     seed: int = 0) -> Dict[str, torch.Tensor]:
    """Parameter gradients of (pred, ga) contracted with (ct_pred, ct_ga)."""
    _check_packed_inputs(inputs)
    dev = inputs["atomic"].device
    if dev.type == "cpu":
        return reference_fused_scann_grad(params, inputs, cfm, ct_pred, ct_ga,
                                          dropout_rate, seed)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    packed = pack_params(params, cfm)
    flat, _ = launch_scann_backward(packed, inputs, cfm, torch.as_tensor(ct_pred, device=dev),
                                    torch.as_tensor(ct_ga, device=dev), False, False,
                                    dropout_rate, seed)
    return grads_from_flat(flat, packed, cfm)


def fused_scann_train_grads(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                            targets, cfm: ModelConfig, mrelu_head: bool = False,
                            dropout_rate: float = 0.0, seed: int = 0
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-shot training: forward, residual and backward in one launch.
    Returns (pred [B, 1], raw gradients of 0.5 * sum((pred - t)^2)); the
    caller turns them into RMSE + l2 gradients (``train.loop``)."""
    _check_packed_inputs(inputs)
    dev = inputs["atomic"].device
    if dev.type == "cpu":
        return reference_fused_scann_train_grads(params, inputs, targets, cfm, mrelu_head,
                                                 dropout_rate, seed)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    packed = pack_params(params, cfm)
    flat, pred = launch_scann_backward(packed, inputs, cfm, torch.as_tensor(targets, device=dev),
                                       None, True, mrelu_head, dropout_rate, seed)
    return pred.view(-1, 1), grads_from_flat(flat, packed, cfm)


# --- the products of csrc/scann_mma.cuh ------------------------------------------

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def reference_tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a @ b`` as the backward kernels' tensor-core products compute it:
    each float32 operand split into hi = tf32(x) and lo = tf32(x - hi), the
    tile summed from a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first,
    accumulated in float32. ``passes=1`` keeps a_hi b_hi alone: one TF32
    pass, three digits."""
    a_hi, b_hi = round_tf32(a), round_tf32(b)
    exact = lambda x, y: (x.double() @ y.double())   # TF32 products are exact in f32
    if passes == 1:
        return exact(a_hi, b_hi).float()
    a_lo, b_lo = round_tf32(a - a_hi), round_tf32(b - b_hi)
    return ((exact(a_lo, b_hi) + exact(a_hi, b_lo)).float().double()
            + exact(a_hi, b_hi)).float()


def mma_selftest(a: torch.Tensor, w: torch.Tensor, y: torch.Tensor):
    """Run the three products of ``csrc/scann_mma.cuh`` on one CUDA block:
    a [rows <= 64, K] @ w [K, nc] through ``mma_gemm``, the same through
    ``mma_gemm_tB`` on w's transpose, and a^T y with y [rows, nc] and y's
    column sums through ``mma_gemm_tA`` (the second of two calls adds to the
    first, as from the second chunk of rows on). Returns (a @ w, a @ w by the
    transposed form, a^T y, column sums of y)."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    rows, K = a.shape
    nc = w.shape[1]
    if w.shape != (K, nc) or y.shape != (rows, nc):
        raise ValueError(f"shapes {tuple(a.shape)}, {tuple(w.shape)}, {tuple(y.shape)}")
    a, w, y = (t.to(torch.float32).contiguous() for t in (a, w, y))
    wt = w.t().contiguous()
    out = [torch.empty(shape, device=dev, dtype=torch.float32)
           for shape in ((rows, nc), (rows, nc), (K, nc), (nc,))]
    call_kernel("scann_backward", "scann_mma_selftest", dev, [a, w, wt, y] + out,
                [rows, K, nc], [0.0])
    return out[0], out[1], out[2] / 2, out[3] / 2


# --- differentiable wrapper ---------------------------------------------------

class _ScannApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, inputs, *values):
        keys, cfm, mrelu_head, dropout_rate, seed = spec
        params = dict(zip(keys, values))
        pred, ga = fused_scann_forward(params, inputs, cfm, mrelu_head, dropout_rate, seed)
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
        grads = fused_scann_grad(params, ctx.inputs, cfm, ct_pred, ct_ga, dropout_rate, seed)
        return (None, None, *[grads[k] for k in keys])


def scann_apply(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                cfm: ModelConfig, mrelu_head: bool = False, dropout_rate: float = 0.0,
                seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable whole-model forward -> (pred [B, 1], ga [B, M, 1]):
    ``torch.autograd`` through it runs the backward kernel (parameter
    gradients only). ``dropout_rate`` > 0 applies the training dropout with
    the same masks in forward and backward."""
    keys = tuple(params)
    spec = (keys, cfm, mrelu_head, dropout_rate, seed)
    return _ScannApply.apply(spec, inputs, *[params[k] for k in keys])


def backward_flops(cfm: ModelConfig, B: int, M: int, N: int) -> int:
    """Multiply-add FLOPs (2 per FMA) that the function needs at one padded
    batch, whatever the schedule: the forward (``forward_flops``) once,
    and for each of its products the gradient of the weight and of the
    input, except where the input is data (the cgcnn features, the RBF
    expansion of the distances), which needs none. The kernel's bound is
    computed from this count."""
    D, K, E = cfm.local_dim, cfm.num_gaussian, cfm.embedding_dim
    R = M * N
    mm = lambda rows, k, n: 2 * rows * k * n
    f = 3 * forward_flops(cfm, 1, M, N)
    if cfm.feature == "cgcnn":
        f -= mm(M, CGCNN_FEATURES, E)
    f -= (2 if cfm.g_update else cfm.n_attention) * mm(R, K, D)
    return B * f


def recompute_flops(cfm: ModelConfig, B: int, M: int, N: int) -> int:
    """FLOPs that the kernel's schedule adds to ``backward_flops`` at one
    padded batch: the forward again in the reverse walk, except each
    layer's context, which the stash keeps. Elementwise work, softmax and
    LayerNorm are left out, as in ``forward_flops``."""
    D, K, E, G, O = (cfm.local_dim, cfm.num_gaussian, cfm.embedding_dim,
                     cfm.global_dim, cfm.dense_out)
    R = M * N
    mm = lambda rows, k, n: 2 * rows * k * n
    f = mm(M, D, G) + 2 * mm(M, G, G) + 6 * M * G + mm(1, G, O) + 2 * O   # readout
    per_layer = 2 * mm(M, D, D)                                   # ResidualNorm
    per_layer += (2 if cfm.g_update else 1) * mm(M, D, D)         # query (and cw)
    per_layer += (mm(R, 2 * D, D) if cfm.g_update else mm(R, K, D)) + mm(R, D, D)  # rows
    per_layer += 2 * R * D                                        # energies
    f += cfm.n_attention * per_layer
    f += mm(M, E + (10 if cfm.use_ring else 0), D)                # embedding
    if cfm.feature == "cgcnn":
        f += mm(M, CGCNN_FEATURES, E)
    if cfm.g_update:
        f += 2 * mm(R, K, D)                                      # geometry embedding
    return B * f
