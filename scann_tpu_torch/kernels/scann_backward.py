"""Whole-model SCANN backward on the GPU: the wrapper around
``csrc/scann_backward.cu``.

Replaces ``scann_tpu/kernels/scann_backward.py:_kernel`` (the Pallas TPU
kernel that recomputes the forward and returns every parameter gradient in
one program).

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
the backward kernel plus its row reduction), ``.bf16_launches`` those in
the bf16 operand mode, ``.stash_launches`` and ``.bf16_stash_launches``
those with the f32 and the bf16 keep-acts stash (``count_launch``).

Schedule (the TPU kernel's ``SCANN_TPU_UNROLL_STASH``, l.258-278): by
default the kernel keeps every layer's activations from its forward pass
(the keep-acts stash) and reads them back in the reverse walk instead of
recomputing them, wherever ``keep_acts_mode`` admits it: the stash's bytes
(``keep_acts_stash_bytes``, 1.28 GB at QM9's batch of 128) against
``STASH_BUDGET_BYTES`` (6 GiB of device memory a launch, a constant).
``SCANN_TPU_UNROLL_STASH=0`` runs the recompute schedule;
``SCANN_TPU_STASH_BF16=1`` keeps the five row tensors of ``_BF16_KEYS`` in
bfloat16 (l.264-271), whatever the f32 stash's size. The f32 stash computes
the recompute schedule's function, bit for bit on the card; the bf16 stash
rebuilds gradients from rounded activations, and its plain version is the
reverse walk of ``reference_stash_*`` (the TPU kernel's reverse body on the
kept acts, one ``torch.autograd.Function`` a layer). ``_launch(...,
stash=)`` takes another schedule (None, ``"f32"``, ``"bf16"``).

``model.dtype: "bfloat16"`` trains in the bf16 operand mode of
``kernels/dots.py``, as ``scann_backward.py:661`` does (``bf16=``): every
product of the forward recompute and of the backward rounds both operands
to bfloat16, the cotangent of a transposed product included, and sums in
f32; the kernel is ``csrc/scann_backward_bf16.cu`` (the same source built
for that mode). Its plain version is ``kfwd.reference_bf16_forward``
differentiated by ``torch.autograd`` (``training_forward``). Params, their
gradients and the packed pools stay f32.

The gate (``refusal``) is the kernel's own shared-memory plan: seven
[M, max(D, G)] buffers stay resident, so M <= 32 at D = G = 128; larger
buckets train through the backward of the crystal loop kernel
(``kernels.scann_loop``). The kernel's products run on the tensor cores as
split-TF32 ``mma.sync`` (``csrc/scann_mma.cuh``: three TF32 passes per tile,
accumulated in f32), which keeps f32 accuracy; ``reference_tf32x3_matmul``
is that arithmetic in plain PyTorch and ``mma_selftest`` runs the header's
three products on the card. A packed batch (``segment_onehot`` [B, M, S],
structure packing) takes the per-segment readout: the cotangent, the
targets and pred are [B, S], and in one-shot mode the residual of a segment
without atoms is zeroed, so the caller divides by the count of valid
segments (``scann_backward.py:727-749``); the plan grows by the per-segment
vectors (``max_segments``). Bound and design are in the source note of
``csrc/scann_backward.cu``; ``backward_flops`` counts the products the
function needs, ``recompute_flops`` those the kernel's schedule adds.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch

from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.kernels import dots
from scann_tpu_torch.kernels.scann_forward import (
    MAX_ATOMS,
    MAX_SHARED_BYTES,
    NARROW_WIDTH,
    RBF_WIDTH,
    _LAYER_KEYS,
    AttentionLayer,
    _check_shapes,
    attention_scale,
    call_kernel,
    dropout_masks_for,
    forward_flops,
    forward_fp32_flops,
    fused_scann_forward,
    largest_segments,
    layer_weights,
    operand_mode,
    pack_params,
    reference_bf16_forward,
    rng_words,
    seg_backward_floats,
    segment_arguments,
    segment_count,
    segment_refusal,
    whole_model_forward,
)
from scann_tpu_torch.models.scann import CGCNN_FEATURES, check_index_ranges, scann_forward

REPLACES = "scann_tpu/kernels/scann_backward.py:77"  # _kernel
SOURCE = "scann_tpu_torch/csrc/scann_backward.cu"
MAX_CHUNK_ROWS = 32
# This kernel (#2) holds 4 values of a row a lane in its warp LayerNorms and
# seven resident [M, max(D, G)] buffers: D, G, O up to 128. A wider model
# trains on the loop backward (#4), whose tall and wide builds take widths
# up to ``kfwd.MAX_WIDTH`` (``Trainer.train_route``), as the forwards do.
MAX_WIDTH = NARROW_WIDTH
N_WARPS = 8
# The device memory one backward launch may give its activation stash (this
# kernel's keep-acts stash, the loop backward's selective stash): 6 GiB. It
# admits the f32 stash of every published shape: QM9 (B=128, M=32, N=16) 1.28
# GB, MP2018 (64, 96, 32) 2.78 GB and its B=128 5.55 GB, Pt/graphene (64, 128,
# 32) 4.52 GB; Pt/graphene at B=128 (9.04 GB) takes the bf16 stash (4.52 GB)
# under SCANN_TPU_LOOP_STASH_BF16=1, else the recompute schedule. A constant,
# never what the card has free: the schedule, and with it the gradients' bits,
# must not depend on what else holds the card.
STASH_BUDGET_BYTES = 6 << 30
AUTO = "auto"   # a launch's stash argument: the mode rule's choice
STASH_MODES = (None, "f32", "bf16")

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


def shared_memory_plan(cfm: ModelConfig, M: int, N: int, S: int = 0) -> Tuple[int, int]:
    """(atoms per chunk of rows, shared bytes per block): the layout
    ``make_plan`` in the CUDA source walks (with the per-segment readout's
    vectors for a packed batch of S segments a slot)."""
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
    if S:
        work = max(work, 5 * MW + seg_backward_floats(S, wd, M, O))
    floats = 7 * MW + work + N_WARPS * 2 * wd + 2 * wd
    return chunk_atoms, 4 * floats


def max_segments(cfm: ModelConfig, M: int, N: int) -> int:
    """The largest S a packed batch of shape (M, N) may have here."""
    return largest_segments(lambda S: shared_memory_plan(cfm, M, N, S)[1])


def refusal(cfm: ModelConfig, M: int, N: int, S: int = 0) -> Optional[str]:
    """Why the backward kernel does not take (config, M, N) at S segments a
    slot (0: unpacked), or None where it does: the gate, read by
    ``check_supported`` and by the dispatch in ``Trainer.train_route``."""
    if M > MAX_ATOMS:
        return (f"M={M} atoms: the whole-model backward takes M <= {MAX_ATOMS}; larger "
                "structures train through the backward of the crystal loop kernel "
                "(kernels.scann_loop.loop_scann_train_grads)")
    if not cfm.use_attn_norm:
        return ("use_attn_norm=False: the kernel always applies ResidualNorm; that "
                "configuration trains through the per-layer model")
    reason = dtype_refusal(cfm)
    if reason:
        return reason
    D, G, O, E = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.embedding_dim
    if any(x > MAX_WIDTH for x in (D, G, O)):
        return (f"D={D}, G={G}, O={O}: the molecule backward takes D, G, O <= {MAX_WIDTH}; "
                "a wider model trains through the backward of the crystal loop kernel "
                "(kernels.scann_loop.loop_scann_train_grads, its *_d256 and *_d512 builds)")
    if (N < 1 or N > MAX_CHUNK_ROWS or any(x % 4 for x in (D, G, O))
            or E % 4 or D % cfm.num_head or cfm.num_gaussian > D):
        return (f"sizes outside the backward kernel's tiles: N={N} (<= {MAX_CHUNK_ROWS}), "
                f"D={D}, G={G}, O={O} (multiples of 4, <= {MAX_WIDTH}), E={E} "
                f"(multiple of 4), D % num_head == 0, num_gaussian <= D")
    reason = segment_refusal(S)
    if reason:
        return reason
    nbytes = shared_memory_plan(cfm, M, N, S)[1]
    if nbytes > MAX_SHARED_BYTES:
        return (f"M={M}, N={N}" + (f", S={S}" if S else "") + ": the backward's "
                f"shared-memory plan of {nbytes} bytes exceeds {MAX_SHARED_BYTES}; larger "
                "structures train through the backward of the crystal loop kernel "
                "(kernels.scann_loop.loop_scann_train_grads)")
    return None


def dtype_refusal(cfm: ModelConfig) -> Optional[str]:
    """What both backward kernels say to a model.dtype other than float32
    and bfloat16 (the bf16 operand mode), None for those two."""
    if cfm.dtype in ("float32", "bfloat16"):
        return None
    return (f"model.dtype={cfm.dtype!r}: the backward kernels take float32 and bfloat16 "
            "(the bf16 operand mode)")


def check_supported(cfm: ModelConfig, M: int, N: int, S: int = 0) -> None:
    """Raise NotImplementedError for what the backward kernel does not take."""
    reason = refusal(cfm, M, N, S)
    if reason:
        raise NotImplementedError(reason)


# --- the keep-acts stash ------------------------------------------------------

def keep_acts_stash_bytes(cfm: ModelConfig, B: int, M: int, N: int, mode: Optional[str]) -> int:
    """Bytes of the keep-acts stash of one launch at batch shape (B, M, N)
    (``keep_acts_scratch``): the row tensors ns, u_pre, key, geo_term and
    (SCANN+) LN_g's x-hat [L, M*N, D] at 4 bytes (``"f32"``) or 2
    (``"bf16"``), the attention [L, M*N, H] and (SCANN+) LN_g's rsqrt
    [L, M*N] in f32, six per-atom tensors [L, M, D] and two rsqrt [L, M] in
    f32; 0 for the recompute schedule (None)."""
    if mode is None:
        return 0
    L, D, H, R = cfm.n_attention, cfm.local_dim, cfm.num_head, M * N
    big = 2 if mode == "bf16" else 4
    rows = (5 if cfm.g_update else 4) * R * D * big
    return B * L * (rows + 4 * (R * H + (R if cfm.g_update else 0) + 6 * M * D + 2 * M))


def keep_acts_mode(cfm: ModelConfig, B: int, M: int, N: int) -> Optional[str]:
    """The schedule of a molecule-backward launch at (B, M, N), as
    ``scann_backward.py:258-271`` chooses it: ``"f32"`` (keep-acts, exact),
    ``"bf16"`` (keep-acts with the five row tensors of ``_BF16_KEYS``
    rounded to bfloat16) or None (recompute). ``SCANN_TPU_UNROLL_STASH=0``
    forces None; ``SCANN_TPU_STASH_BF16=1`` makes the stash bf16
    unconditionally (the JAX package's experiment switch, whatever the f32
    stash's size). A stash larger than ``STASH_BUDGET_BYTES`` gives None. A pure
    function of the config, the shape and the environment."""
    if os.environ.get("SCANN_TPU_UNROLL_STASH", "1") == "0":
        return None
    mode = "bf16" if os.environ.get("SCANN_TPU_STASH_BF16", "0") == "1" else "f32"
    return mode if keep_acts_stash_bytes(cfm, B, M, N, mode) <= STASH_BUDGET_BYTES else None


def keep_acts_scratch(cfm: ModelConfig, B: int, M: int, N: int, mode: Optional[str],
                      device) -> Dict[str, Optional[torch.Tensor]]:
    """The keep-acts stash of one launch (all None for the recompute
    schedule), in ``csrc/scann_backward.cu``'s layout: ``stash_rows`` [B, L,
    4 or 5, M*N, D] (f32 or bfloat16), ``stash_attn`` [B, L, M*N, H],
    ``stash_ginv`` [B, L, M*N] (SCANN+), ``stash_atoms`` [B, L, 6, M, D] and
    ``stash_inv`` [B, L, 2, M]."""
    keys = ("stash_rows", "stash_attn", "stash_ginv", "stash_atoms", "stash_inv")
    if mode is None:
        return dict.fromkeys(keys)
    L, D, H, R = cfm.n_attention, cfm.local_dim, cfm.num_head, M * N
    f32 = lambda *shape: torch.empty(shape, device=device, dtype=torch.float32)
    big = torch.bfloat16 if mode == "bf16" else torch.float32
    return {"stash_rows": torch.empty((B, L, 5 if cfm.g_update else 4, R, D), device=device,
                                      dtype=big),
            "stash_attn": f32(B, L, R, H), "stash_ginv": f32(B, L, R) if cfm.g_update else None,
            "stash_atoms": f32(B, L, 6, M, D), "stash_inv": f32(B, L, 2, M)}


def stash_element_bytes(mode: Optional[str]) -> int:
    """The kernels' stash flag: 0 (recompute), 4 (f32) or 2 (bf16)."""
    return {None: 0, "f32": 4, "bf16": 2}[mode]


def resolve_stash(stash, rule, cfm: ModelConfig, B: int, M: int, N: int) -> Optional[str]:
    """A launch's ``stash`` argument as a mode: ``AUTO`` asks ``rule``."""
    mode = rule(cfm, B, M, N) if stash == AUTO else stash
    if mode not in STASH_MODES:
        raise ValueError(f"stash={stash!r}: one of {STASH_MODES} or {AUTO!r}")
    return mode


# --- the plain version -------------------------------------------------------

def _as_rows(x, B: int, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(B, -1)


def segment_valid(inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[B, S]: 1 for a segment of a packed batch that holds atoms, 0 for an
    empty one, as the TPU kernels count it (``scann_backward.py:348-352``)."""
    seg = inputs["segment_onehot"].float()
    return ((seg * inputs["atom_mask"].float()).sum(dim=1) > 0).float()


def training_forward(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                     cfm: ModelConfig, mrelu_head: bool, masks, exact_pools: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward the plain versions of the backward kernels differentiate:
    the eager model in f32; in the bf16 operand mode
    ``kfwd.reference_bf16_forward``, whose products round the cotangent as
    the TPU backward kernels do (the segment pools f32-exact for this
    kernel, ``exact_pools=False`` the loop kernel's bf16-mode pools)."""
    if cfm.dtype == "bfloat16":
        return reference_bf16_forward(params, inputs, cfm, mrelu_head, exact_pools, masks)
    return scann_forward(params, inputs, cfm, mrelu_head, masks)


def reference_fused_scann_grad(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                               cfm: ModelConfig, ct_pred, ct_ga, dropout_rate: float = 0.0,
                               seed: int = 0, mol_base: int = 0, exact_pools: bool = True
                               ) -> Dict[str, torch.Tensor]:
    """Gradients of sum(pred * ct_pred) + sum(ga * ct_ga) through the
    training forward (``training_forward``; head without mrelu, as the
    kernel's cotangent path); ct_pred is [B, S] for a packed batch."""
    B, M = inputs["atomic"].shape[:2]
    dev = inputs["atomic"].device
    ctp = _as_rows(ct_pred, B, dev)[:, :max(segment_count(inputs), 1)]
    ctg = _as_rows(ct_ga, B, dev).reshape(B, M, 1)
    masks = dropout_masks_for(cfm, inputs, dropout_rate, seed, mol_base)
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        pred, ga = training_forward(leaves, inputs, cfm, False, masks, exact_pools)
        ft = pred.dtype
        loss = (pred * ctp.to(ft)).sum() + (ga * ctg.to(ft)).sum()
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def reference_fused_scann_train_grads(params: Dict[str, torch.Tensor],
                                      inputs: Dict[str, torch.Tensor], targets,
                                      cfm: ModelConfig, mrelu_head: bool = False,
                                      dropout_rate: float = 0.0, seed: int = 0,
                                      mol_base: int = 0, exact_pools: bool = True
                                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(pred [B, 1], gradients of 0.5 * sum((pred - t)^2)) through the
    training forward (``training_forward``); mrelu is straight-through. A
    packed batch has targets and pred [B, S], and the residual of an empty
    segment is zeroed."""
    B = inputs["atomic"].shape[0]
    S = segment_count(inputs)
    y = _as_rows(targets, B, inputs["atomic"].device)
    masks = dropout_masks_for(cfm, inputs, dropout_rate, seed, mol_base)
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        pred, _ = training_forward(leaves, inputs, cfm, mrelu_head, masks, exact_pools)
        y = y.to(pred.dtype)
        if S:
            err = (pred - y) * segment_valid(inputs).to(pred.dtype)
        else:
            err = pred[:, 0] - y[:, 0]
        loss = 0.5 * (err ** 2).sum()
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return pred.detach(), dict(zip(leaves, grads))


# --- the plain versions of the activation stashes ------------------------------
#
# The f32 stashes compute the same function as the recompute schedule, so their
# plain version is the one above. A bf16 stash does not: its reverse walk
# rebuilds gradients from rounded activations, which autograd through the
# forward cannot give (it saves products of f32 values). Here each attention
# layer is a torch.autograd.Function whose forward is the TPU kernels'
# layer_fwd and keeps the stash, and whose backward is their reverse body on
# what the stash holds (scann_backward.py:412-530, scann_loop.py:762-886); the
# embedding and the readout around the layers are differentiated by autograd
# as in the plain versions above.

def _swish_grad(x: torch.Tensor) -> torch.Tensor:
    sg = torch.sigmoid(x)
    return sg * (1.0 + x * (1.0 - sg))


def _ln_bwd(dy: torch.Tensor, xhat: torch.Tensor, inv: torch.Tensor, gamma: torch.Tensor):
    """(dx, d gamma rows, d beta rows), as the TPU kernels' _ln_bwd."""
    dxhat = dy * gamma
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return inv * (dxhat - m1 - xhat * m2), dy * xhat, dy


class _Layer(AttentionLayer):
    """``kfwd.AttentionLayer`` in ``cfm``'s operand mode, with the TPU
    kernels' reverse body of the layer."""

    def __init__(self, inputs, cfm: ModelConfig, masks, l: int, rbf_d):
        super().__init__(inputs, cfm, masks, l, rbf_d, operand_mode(cfm) == 1)
        _, _, self.mm_tB, _, self.dot3_tB, self.mm3_tA = dots.dot_fns(self.bf16)

    def gather_t(self, dns):     # mm_tA(n_oh, dns): each neighbour row into its atom
        return self.scatter(self.r(dns))

    def backward(self, w, a, c_in, g_in, dc, dg):
        """The TPU kernels' reverse body of one layer on the acts ``a``:
        (d c_in, d g_in, the layer's weight gradients)."""
        mm_tB, dot3_tB, mm3_tA, D = self.mm_tB, self.dot3_tB, self.mm3_tA, self.D
        rows = lambda x: x.reshape(-1, x.shape[-1]).sum(0)
        gr = {}
        dsum, dgam, dbet = _ln_bwd(dc, a["c_xhat"], a["c_inv"], w["rln_s"])
        gr["rln_s"], gr["rln_b"] = rows(dgam), rows(dbet)
        dh2 = dsum * self.res_mask if self.res_mask is not None else dsum
        gr["wr2"], gr["br2"] = mm3_tA(a["h1"], dh2), rows(dh2)
        ds1 = mm_tB(dh2, w["wr2"]) * _swish_grad(a["s1"])
        gr["wr1"], gr["br1"] = mm3_tA(a["o1"], ds1), rows(ds1)
        do1 = dsum + mm_tB(ds1, w["wr1"])
        dcq, dgam, dbet = _ln_bwd(do1, a["o_xhat"], a["o_inv"], w["ln_s"])
        gr["ln_s"], gr["ln_b"] = rows(dgam), rows(dbet)
        # ctx from the post-dropout attention; the softmax backward on the
        # pre-dropout one, d attn gated by the mask
        dctx3 = dcq[:, :, None, :]
        nm3 = self.nmask[..., None]
        key, attn, ns = a["key"], a["attn"], a["ns"]
        dkey = dctx3 * self.lanes(a["attn_used"]) * nm3
        dattn = self.head_sum(dctx3 * nm3 * key)
        if self.amask is not None:
            dattn = dattn * self.amask
        de = attn * (dattn - (attn * dattn).sum(dim=2, keepdim=True))
        dprod = self.lanes(de)
        dkey = dkey + dprod * (a["query"] * self.dk)[:, :, None, :]
        dquery = dcq + (dprod * key).sum(dim=2) * self.dk
        gr["wk"], gr["bk"] = mm3_tA(ns * a["geo_term"], dkey), rows(dkey)
        dkin = dot3_tB(dkey, w["wk"])
        dns = dkin * a["geo_term"]
        dgeo_term = dkin * ns
        gr["wq"], gr["bq"] = mm3_tA(c_in, dquery), rows(dquery)
        dc_new = mm_tB(dquery, w["wq"])
        dg_new = None
        if self.cfm.g_update:
            dgout = dgeo_term if dg is None else dgeo_term + dg
            dr, dgam3, dbet3 = _ln_bwd(dgout, a["g_xhat"], a["g_inv"], w["lng_s"])
            gr["lng_s"], gr["lng_b"] = rows(dgam3), rows(dbet3)
            du_pre = dr * _swish_grad(a["u_pre"])
            dcw = du_pre.sum(dim=2)
            wfg = w["wfg"]
            gr["wfg"] = torch.cat([mm3_tA(c_in, dcw), mm3_tA(g_in, du_pre), mm3_tA(ns, du_pre)])
            gr["bfg"] = rows(du_pre)
            dc_new = dc_new + mm_tB(dcw, wfg[:D])
            dg_new = dr + dot3_tB(du_pre, wfg[D:2 * D])
            dns = dns + dot3_tB(du_pre, wfg[2 * D:])
        else:
            du_pre = dgeo_term * self.weight[..., None] * _swish_grad(a["u_pre"])
            gr["wfg"], gr["bfg"] = mm3_tA(self.rbf_d, du_pre), rows(du_pre)
        return dc_new + self.gather_t(dns), dg_new, gr


# what this kernel's bf16 stash rounds: _BF16_KEYS of scann_backward.py:264
KEEP_ACTS_BF16_KEYS = ("ns", "u_pre", "geo_term", "g_xhat", "key")


def keep_acts_stash(acts, mode: str):
    """This kernel's keep-acts stash of a layer's acts (``_stash_cast``): in
    the bf16 stash ``KEEP_ACTS_BF16_KEYS`` rounded to bfloat16."""
    if mode != "bf16":
        return acts
    return {k: (dots.round_bf16(v) if k in KEEP_ACTS_BF16_KEYS and v is not None else v)
            for k, v in acts.items()}


def keep_acts_rebuild(stash, layer: _Layer, w, c_in, g_in):
    """The reverse walk's acts from this kernel's stash: as kept."""
    return stash


class _StashedLayer(torch.autograd.Function):
    """One attention layer whose backward runs from an activation stash:
    ``spec`` = (layer, weight names, keep, rebuild, mode); ``keep(acts,
    mode)`` is what the forward pass stashes, ``rebuild(stash, layer, w,
    c_in, g_in)`` the acts the reverse walk takes from it."""

    @staticmethod
    def forward(ctx, spec, c, g, *values):
        layer, names, keep, rebuild, mode = spec
        w = dict(zip(names, values))
        g_in = g if layer.cfm.g_update else None
        c_out, g_out, acts = layer.forward(w, c, g_in)
        ctx.spec, ctx.stash = spec, keep(acts, mode)
        ctx.save_for_backward(c, g, *values)
        return c_out, (g_out if layer.cfm.g_update else g.clone())

    @staticmethod
    def backward(ctx, dc, dg):
        layer, names, keep, rebuild, mode = ctx.spec
        c, g, *values = ctx.saved_tensors
        w = dict(zip(names, values))
        g_in = g if layer.cfm.g_update else None
        acts = rebuild(ctx.stash, layer, w, c, g_in)
        dc_in, dg_in, gr = layer.backward(w, acts, c, g_in, dc, dg)
        return (None, dc_in, dg_in, *[gr.get(n) for n in names])


def stash_training_forward(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                           cfm: ModelConfig, mrelu_head: bool, masks, mode: str, keep, rebuild,
                           exact_pools: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward (``kfwd.whole_model_forward`` in ``cfm``'s
    operand mode) whose attention layers are ``_StashedLayer``s: under
    ``torch.autograd`` it gives the gradients of a backward kernel with the
    activation stash ``mode``, kept by ``keep`` and read back by
    ``rebuild``."""
    def layer(l, centers, geometry, rbf_d):
        w = layer_weights(params, l, cfm.g_update)
        names, values = list(w), list(w.values())
        spec = (_Layer(inputs, cfm, masks, l, rbf_d), names, keep, rebuild, mode)
        g = geometry if cfm.g_update else centers.new_zeros(0)
        c_out, g_out = _StashedLayer.apply(spec, centers, g, *values)
        return c_out, (g_out if cfm.g_update else None)

    return whole_model_forward(params, inputs, cfm, mrelu_head, exact_pools, masks,
                               operand_mode(cfm) == 1, layer)


def reference_stash_grad(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                         cfm: ModelConfig, ct_pred, ct_ga, dropout_rate: float = 0.0,
                         seed: int = 0, mol_base: int = 0, mode: str = "bf16",
                         keep=keep_acts_stash, rebuild=keep_acts_rebuild,
                         exact_pools: bool = True) -> Dict[str, torch.Tensor]:
    """The plain version of a backward kernel's cotangent launch with the
    activation stash ``mode`` (this kernel's keep-acts stash by default; the
    loop kernel passes its own ``keep`` and ``rebuild``): gradients of
    sum(pred * ct_pred) + sum(ga * ct_ga)."""
    B, M = inputs["atomic"].shape[:2]
    dev = inputs["atomic"].device
    ctp = _as_rows(ct_pred, B, dev)[:, :max(segment_count(inputs), 1)]
    ctg = _as_rows(ct_ga, B, dev).reshape(B, M, 1)
    masks = dropout_masks_for(cfm, inputs, dropout_rate, seed, mol_base)
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        pred, ga = stash_training_forward(leaves, inputs, cfm, False, masks, mode, keep,
                                          rebuild, exact_pools)
        loss = (pred * ctp.to(pred.dtype)).sum() + (ga * ctg.to(pred.dtype)).sum()
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def reference_stash_train_grads(params: Dict[str, torch.Tensor],
                                inputs: Dict[str, torch.Tensor], targets, cfm: ModelConfig,
                                mrelu_head: bool = False, dropout_rate: float = 0.0,
                                seed: int = 0, mol_base: int = 0, mode: str = "bf16",
                                keep=keep_acts_stash, rebuild=keep_acts_rebuild,
                                exact_pools: bool = True
                                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The plain version of a one-shot launch with the activation stash
    ``mode``: (pred [B, 1] or [B, S], gradients of 0.5 * sum((pred - t)^2)),
    as ``reference_fused_scann_train_grads``."""
    B = inputs["atomic"].shape[0]
    S = segment_count(inputs)
    y = _as_rows(targets, B, inputs["atomic"].device)
    masks = dropout_masks_for(cfm, inputs, dropout_rate, seed, mol_base)
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        pred, _ = stash_training_forward(leaves, inputs, cfm, mrelu_head, masks, mode, keep,
                                         rebuild, exact_pools)
        y = y.to(pred.dtype)
        err = (pred - y) * segment_valid(inputs).to(pred.dtype) if S else pred[:, 0] - y[:, 0]
        grads = torch.autograd.grad(0.5 * (err ** 2).sum(), list(leaves.values()))
    return pred.detach(), dict(zip(leaves, grads))


# --- the kernel --------------------------------------------------------------

def launch_scann_backward(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                          cfm: ModelConfig, ct: torch.Tensor, ct_ga: Optional[torch.Tensor],
                          one_shot: bool, mrelu_head: bool = False, dropout_rate: float = 0.0,
                          seed: int = 0, mol_base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check CUDA inputs and launch the backward kernel and its reduction
    with ``pack_params`` output (index ranges are the caller's, as
    ``kernels.scann_forward.launch_scann_forward`` says). ``ct`` [B] is d
    pred, or the targets when ``one_shot``; ``ct_ga`` [B, M] (ignored when
    ``one_shot``). A packed batch has ``ct`` [B, S]. The schedule is
    ``keep_acts_mode``'s. Returns (flat gradients [P], pred [B], or [B * S]
    packed)."""
    dev = packed["wde"].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    _check_shapes(inputs, cfm, dev)
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
    length last), and the outputs (flat gradients [P], pred [B], or [B * S]
    for a packed batch of S segments a slot, whose ``ct`` is [B, S])."""
    dev = packed["wde"].device
    B, M = inputs["atomic"].shape[:2]
    N = inputs["neighbors"].shape[2]
    S = segment_count(inputs)
    cgcnn = cfm.feature == "cgcnn"
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).reshape(B, -1).contiguous()
    ct = f32(ct)[:, :max(S, 1)].contiguous()
    ct_ga = f32(ct_ga) if ct_ga is not None and not one_shot else None
    offsets, P = grad_layout(packed)
    flat = torch.empty(P, device=dev, dtype=torch.float32)
    pred = torch.empty(B * max(S, 1), device=dev, dtype=torch.float32)
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
            mol_base: int = 0, stash=AUTO) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch itself, on inputs ``_check_shapes`` accepted, with the
    schedule ``stash`` (``AUTO``: ``keep_acts_mode``'s; None, ``"f32"`` or
    ``"bf16"`` force one, for the checks that hold one schedule against
    another)."""
    B, M = inputs["atomic"].shape[:2]
    N = inputs["neighbors"].shape[2]
    seg, S = segment_arguments(inputs)
    check_supported(cfm, M, N, S)
    mode = resolve_stash(stash, keep_acts_mode, cfm, B, M, N)
    chunk_atoms, _ = shared_memory_plan(cfm, M, N, S)
    dev = packed["wde"].device
    scratch = allocate_scratch(packed, cfm, B, M, N, cfm.n_attention)
    scratch.update(keep_acts_scratch(cfm, B, M, N, mode, dev))
    tensors, dims, scalars, rng, offsets, flat, pred = launch_arguments(
        packed, inputs, cfm, ct, ct_ga, one_shot, mrelu_head, dropout_rate, seed, mol_base,
        chunk_atoms, scratch)
    name = kernel_name("scann_backward", cfm)
    call_kernel(name, name, dev,
                tensors + [seg] + [scratch[k] for k in ("stash_rows", "stash_attn", "stash_ginv",
                                                        "stash_atoms", "stash_inv")],
                dims + [S, stash_element_bytes(mode)], scalars, rng, offsets, flat)
    count_launch(launch_scann_backward, cfm, mode)
    return flat, pred


def count_launch(launcher, cfm: ModelConfig, mode: Optional[str]) -> None:
    """Add a backward launch to ``launcher``'s counts: ``.launches`` all,
    ``.bf16_launches`` those in the bf16 operand mode, ``.stash_launches``
    those with the f32 activation stash, ``.bf16_stash_launches`` those with
    the bf16 one (the rest ran the recompute schedule)."""
    launcher.launches += 1
    launcher.bf16_launches += operand_mode(cfm)
    launcher.stash_launches += mode == "f32"
    launcher.bf16_stash_launches += mode == "bf16"


def reset_counts(launcher) -> None:
    """Set a backward launcher's counts to 0 (``.wide_launches``,
    ``.tall_launches``, ``.d256_launches`` and ``.d512_launches``: the loop
    backward's wide and tall builds, and those of widths past 128 and past
    256)."""
    for name in ("launches", "bf16_launches", "stash_launches", "bf16_stash_launches",
                 "wide_launches", "tall_launches", "d256_launches", "d512_launches"):
        setattr(launcher, name, 0)


reset_counts(launch_scann_backward)


def kernel_name(base: str, cfm: ModelConfig) -> str:
    """The library and entry point of a backward kernel in ``cfm``'s mode:
    ``<base>`` in f32, ``<base>_bf16`` (its own build of the same source,
    ``csrc/<base>_bf16.cu``) in the bf16 operand mode."""
    return base + "_bf16" if operand_mode(cfm) else base


def fused_scann_grad(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                     cfm: ModelConfig, ct_pred, ct_ga, dropout_rate: float = 0.0,
                     seed: int = 0, mol_base: int = 0) -> Dict[str, torch.Tensor]:
    """Parameter gradients of (pred, ga) contracted with (ct_pred, ct_ga)
    (ct_pred [B, S] for a packed batch)."""
    dev = inputs["atomic"].device
    if dev.type == "cpu":
        B, M = inputs["atomic"].shape[:2]
        if keep_acts_mode(cfm, B, M, inputs["neighbors"].shape[2]) == "bf16":
            return reference_stash_grad(params, inputs, cfm, ct_pred, ct_ga, dropout_rate,
                                        seed, mol_base)
        return reference_fused_scann_grad(params, inputs, cfm, ct_pred, ct_ga,
                                          dropout_rate, seed, mol_base)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_index_ranges(inputs, cfm)
    packed = pack_params(params, cfm)
    flat, _ = launch_scann_backward(packed, inputs, cfm, torch.as_tensor(ct_pred, device=dev),
                                    torch.as_tensor(ct_ga, device=dev), False, False,
                                    dropout_rate, seed, mol_base)
    return grads_from_flat(flat, packed, cfm)


def fused_scann_train_grads(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                            targets, cfm: ModelConfig, mrelu_head: bool = False,
                            dropout_rate: float = 0.0, seed: int = 0, mol_base: int = 0
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-shot training: forward, residual and backward in one launch.
    Returns (pred [B, 1], raw gradients of 0.5 * sum((pred - t)^2)); the
    caller turns them into RMSE + l2 gradients (``train.loop``). A packed
    batch has targets and pred [B, S]; an empty segment's residual is
    zeroed, so the caller divides by the count of valid segments."""
    dev = inputs["atomic"].device
    if dev.type == "cpu":
        B, M = inputs["atomic"].shape[:2]
        if keep_acts_mode(cfm, B, M, inputs["neighbors"].shape[2]) == "bf16":
            return reference_stash_train_grads(params, inputs, targets, cfm, mrelu_head,
                                               dropout_rate, seed, mol_base)
        return reference_fused_scann_train_grads(params, inputs, targets, cfm, mrelu_head,
                                                 dropout_rate, seed, mol_base)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_index_ranges(inputs, cfm)
    packed = pack_params(params, cfm)
    flat, pred = launch_scann_backward(packed, inputs, cfm, torch.as_tensor(targets, device=dev),
                                       None, True, mrelu_head, dropout_rate, seed, mol_base)
    return pred.view(inputs["atomic"].shape[0], -1), grads_from_flat(flat, packed, cfm)


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
        S = max(segment_count(ctx.inputs), 1)
        ct_pred = d_pred if d_pred is not None else torch.zeros(B, S, device=dev)
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


def backward_fp32_flops(cfm: ModelConfig, B: int, M: int, N: int) -> int:
    """Of ``backward_flops``, the FLOPs that run on the CUDA cores in f32:
    the forward's (``forward_fp32_flops``) and their two gradients; the
    rest are split-TF32 products on the tensor cores."""
    return 3 * forward_fp32_flops(cfm, B, M, N)


def recompute_flops(cfm: ModelConfig, B: int, M: int, N: int,
                    stash: Optional[str] = None) -> int:
    """FLOPs that the kernel's schedule adds to ``backward_flops`` at one
    padded batch. The recompute schedule (``stash`` None): the forward again
    in the reverse walk, except each layer's context, which the stash keeps.
    The keep-acts stash (``"f32"``, ``"bf16"``) keeps every layer's
    activations, so only the readout, the embedding and the SCANN+ geometry
    embedding are formed again. Elementwise work, softmax and LayerNorm are
    left out, as in ``forward_flops``."""
    D, K, E, G, O = (cfm.local_dim, cfm.num_gaussian, cfm.embedding_dim,
                     cfm.global_dim, cfm.dense_out)
    R = M * N
    mm = lambda rows, k, n: 2 * rows * k * n
    f = mm(M, D, G) + 2 * mm(M, G, G) + 6 * M * G + mm(1, G, O) + 2 * O   # readout
    per_layer = 2 * mm(M, D, D)                                   # ResidualNorm
    per_layer += (2 if cfm.g_update else 1) * mm(M, D, D)         # query (and cw)
    per_layer += (mm(R, 2 * D, D) if cfm.g_update else mm(R, K, D)) + mm(R, D, D)  # rows
    per_layer += 2 * R * D                                        # energies
    f += 0 if stash else cfm.n_attention * per_layer
    f += mm(M, E + (10 if cfm.use_ring else 0), D)                # embedding
    if cfm.feature == "cgcnn":
        f += mm(M, CGCNN_FEATURES, E)
    if cfm.g_update:
        f += 2 * mm(R, K, D)                                      # geometry embedding
    return B * f
