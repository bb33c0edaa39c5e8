"""The SCANN / SCANN+ model in plain PyTorch (port of
``scann_tpu/models/scann.py``).

Parameters live in a flat dict keyed by the flax tree's paths joined with
"/" (``embed_atom/embedding``, ``local_attention_0/filter_geo/kernel``,
``residual_norm_0/layer_norm/scale``, ...), so weights move across from the
JAX package (``compat.from_jax.params_from_jax``) or from a reference Keras
H5 (``compat.h5_loader``) without renaming. Dense kernels are stored
``[in, out]`` as in flax and Keras, not ``[out, in]`` as ``nn.Linear`` keeps
them.

Inputs (one padded batch, see ``api.prepare_input``):

    atomic            [B, M] int (or [B, M, 92] float for feature="cgcnn")
    atom_mask         [B, M, 1] float
    neighbors         [B, M, N] int (padding remapped to 0)
    neighbor_mask     [B, M, N] float
    neighbor_weight   [B, M, N] float (solid angle)
    neighbor_distance [B, M, N] float
    ring_aromatic     [B, M, 2] float (only when use_ring)
    segment_onehot    [B, M, S] float (only for packed slots, ``data/packing.py``)

``scann_forward`` is the forward as a plain function of (params, inputs):
deterministic, or the training forward when it is handed the dropout masks
of ``ops.dropout.make_dropout_masks`` (embedding and residual dropout, and
the attention dropout of ``use_drop``). ``ScannModel`` wraps it as an
``nn.Module`` that owns its parameters (``use_pallas=True``: the per-layer
model, whose LocalAttention layers run in the kernel of
``kernels.local_attention`` on CUDA). ``l2_penalty`` is the reference's
kernel regularisation. A packed batch (``segment_onehot`` in the inputs)
gets the per-segment readout and a property of [B, S], one per segment.

``model.dtype: "bfloat16"`` runs the flax model's bf16 semantics
(``scann_tpu/models/scann.py:55-64, 140, 171-177, 197-300``), op by op: the
inputs, the embedding, every Dense but the head and the LocalAttention
parameters are cast to bfloat16, so activations are bfloat16 where the
flax modules' are; the ResidualNorm's LayerNorm and ``predict_property``
compute in f32, and a product of a bfloat16 with an f32 tensor in f32 (jnp's
promotion). The parameters stay f32. This is not what the whole-model
kernels compute in that mode (``kernels/dots.py``: f32 activations, bf16
operands); the per-layer model is this model with kernel #5 launched on its
layers' tensors.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.kernels.local_attention import (
    PARAM_KEYS,
    check_neighbor_range,
    fused_local_attention,
    index_bounds,
    layer_norm,
    reference_local_attention,
)
from scann_tpu_torch.ops.activations import mrelu, swish
from scann_tpu_torch.ops.attention import global_attention_core
from scann_tpu_torch.ops.dropout import DropoutMasks
from scann_tpu_torch.ops.rbf import gaussian_expansion, make_centers

Params = Dict[str, torch.Tensor]

CGCNN_FEATURES = 92


def param_shapes(cfm: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the model for ``cfm``: flat key -> shape, in the
    flax module's creation order."""
    D, K, E = cfm.local_dim, cfm.num_gaussian, cfm.embedding_dim
    G, O = cfm.global_dim, cfm.dense_out
    shapes: Dict[str, Tuple[int, ...]] = {}

    def dense(name, n_in, n_out):
        shapes[f"{name}/kernel"] = (n_in, n_out)
        shapes[f"{name}/bias"] = (n_out,)

    def ln(name):
        shapes[f"{name}/scale"] = (D,)
        shapes[f"{name}/bias"] = (D,)

    if cfm.feature == "atomic":
        shapes["embed_atom/embedding"] = (cfm.n_atoms, E)
    elif cfm.feature == "cgcnn":
        dense("embed_atom", CGCNN_FEATURES, E)
    else:
        raise ValueError(f"unknown feature mode: {cfm.feature}")
    if cfm.use_ring:
        dense("extra_embed", 2, 10)
    dense("dense_embed", E + 10 if cfm.use_ring else E, D)
    if cfm.g_update:
        dense("neighbor_d", K, D)
        dense("neighbor_w", K, D)
    for i in range(cfm.n_attention):
        la = f"local_attention_{i}"
        dense(f"{la}/filter_geo", 3 * D if cfm.g_update else K, D)
        dense(f"{la}/key", D, D)
        dense(f"{la}/query", D, D)
        ln(f"{la}/layer_norm")
        if cfm.g_update:
            ln(f"{la}/layer_norm_g")
        if cfm.use_attn_norm:
            rn = f"residual_norm_{i}"
            dense(f"{rn}/dense_1", D, D)
            dense(f"{rn}/dense_2", D, D)
            ln(f"{rn}/layer_norm")
    dense("after_Lc", D, G)
    dense("global_attention/query", G, G)
    dense("global_attention/key", G, G)
    dense("bf_property", G, O)
    dense("predict_property", O, 1)
    return shapes


def init_params(cfm: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cpu") -> Params:
    """Keras initializers: glorot_uniform dense kernels, zero biases, an
    embedding drawn from U(-0.05, 0.05), LayerNorm scale 1 and bias 0.
    Drawn on the CPU from ``generator``, then moved to ``device``."""
    out: Params = {}
    for key, shape in param_shapes(cfm).items():
        leaf = key.rsplit("/", 1)[1]
        if leaf == "kernel":
            limit = float(np.sqrt(6.0 / (shape[0] + shape[1])))
            t = (torch.rand(shape, generator=generator) * 2 - 1) * limit
        elif leaf == "embedding":
            t = (torch.rand(shape, generator=generator) * 2 - 1) * 0.05
        elif leaf == "scale":
            t = torch.ones(shape)
        else:
            t = torch.zeros(shape)
        out[key] = t.to(device=device, dtype=torch.float32)
    return out


def check_index_ranges(inputs: Dict, cfm: ModelConfig) -> None:
    """Refuse a batch whose atomic numbers fall outside the embedding vocab
    or whose neighbour indices fall outside [0, M): on the card either is an
    out-of-bounds read. ``inputs`` holds numpy arrays (read on the host) or
    tensors (read back once: a wait on their device). The kernels' launch
    wrappers read nothing back, so the entry points that take data check it
    here once: ``Trainer._put_buckets`` each bucket on the host,
    ``Scann.forward_eval`` each batch, the whole-model wrappers with the JAX
    signature (``fused_scann_forward`` and its kin) each call."""
    M = inputs["atomic"].shape[1]
    if cfm.feature == "atomic":
        z_lo, z_hi, lo, hi = index_bounds(inputs["atomic"], inputs["neighbors"])
        if z_lo < 0 or z_hi >= cfm.n_atoms:
            raise ValueError(f"atomic numbers span [{z_lo}, {z_hi}], outside the "
                             f"embedding vocab [0, {cfm.n_atoms})")
    else:
        lo, hi = index_bounds(inputs["neighbors"])
    check_neighbor_range(lo, hi, M)


def compute_dtype(cfm: ModelConfig) -> torch.dtype:
    """The flax model's compute dtype: bfloat16 for ``model.dtype:
    bfloat16``, else float32."""
    return torch.bfloat16 if cfm.dtype == "bfloat16" else torch.float32


def _dense(params: Params, name: str, x: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias cast to ``dtype``."""
    return (x.to(dtype) @ params[f"{name}/kernel"].to(dtype)
            + params[f"{name}/bias"].to(dtype))


def local_attention(params: Params, name: str, centers, neighbor_idx,
                    geometry, neighbor_mask, neighbor_weight, cfm: ModelConfig,
                    attn_mask: Optional[torch.Tensor] = None, use_pallas: bool = False):
    """One LocalAttention layer -> (out [B,M,D], geometry for the next
    layer). ``attn_mask`` [B, M, N, H] is the attention dropout mask
    (training under ``use_drop``). With ``use_pallas`` a layer without
    attention dropout on CUDA tensors is one launch of the per-layer kernel
    (``kernels.local_attention.fused_local_attention``); every other layer
    is the plain ``reference_local_attention``. The layer's parameters are
    cast to the model's compute dtype, as the flax layer casts them."""
    dtype = compute_dtype(cfm)
    layer = {k: params[f"{name}/{k}"].to(dtype) for k in PARAM_KEYS
             if f"{name}/{k}" in params}
    if use_pallas and attn_mask is None and centers.device.type == "cuda":
        out, geo_out, _ = fused_local_attention(
            centers, neighbor_idx, geometry, neighbor_mask, neighbor_weight, layer,
            cfm.num_head, cfm.scale, cfm.g_update)
    else:
        out, geo_out, _ = reference_local_attention(
            centers, neighbor_idx, geometry, neighbor_mask, neighbor_weight, layer,
            cfm.num_head, cfm.scale, cfm.g_update, attn_mask)
    return out, geo_out if cfm.g_update else geometry


def residual_norm(params: Params, name: str, x: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Post-attention FFN block with a residual and a LayerNorm; ``mask``
    is its training dropout on the FFN output (reference ``:54-62``). Its
    Dense layers compute in ``dtype``, its LayerNorm in f32."""
    h = swish(_dense(params, f"{name}/dense_1", x, dtype))
    h = _dense(params, f"{name}/dense_2", h, dtype)
    if mask is not None:
        h = (h * mask).to(h.dtype)      # flax's dropout keeps its input's dtype
    return layer_norm((x + h).float(), params[f"{name}/layer_norm/scale"],
                       params[f"{name}/layer_norm/bias"])


def scann_forward(params: Params, inputs: Dict[str, torch.Tensor],
                  cfm: ModelConfig, mrelu_head: bool = False,
                  masks: Optional[DropoutMasks] = None, use_pallas: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward -> (property [B, 1], ga_score [B, M, 1]), f32; for a packed
    batch (``segment_onehot`` [B, M, S]) the property is [B, S], one per
    segment (an empty segment's is the head on a zero pooled vector).

    ``use_pallas`` (the JAX model's name for it) is the per-layer model: on
    CUDA tensors each LocalAttention layer without attention dropout is one
    launch of the per-layer kernel, the rest stays plain PyTorch. The
    batch's index ranges are the caller's to check (``check_index_ranges``).

    Deterministic without ``masks``; with them, the training forward:
    dropout on the embedding (reference ``scann.py:228``), on each
    ResidualNorm's FFN output, and (``masks.attn``) on the attention
    probabilities; each dropped-out tensor keeps its dtype, as flax's
    ``nn.Dropout`` keeps it (bfloat16 at ``model.dtype: bfloat16``).
    Differentiated by ``torch.autograd`` it is the per-layer training
    route's step, as ``jax.value_and_grad`` of the flax model is the JAX
    Trainer's, in either dtype."""
    if cfm.dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(f"model.dtype={cfm.dtype!r}: float32 or bfloat16")
    dt = compute_dtype(cfm)
    p = params
    atomic = inputs["atomic"]
    dev = atomic.device
    atom_mask = inputs["atom_mask"].to(dt)
    neighbor_idx = inputs["neighbors"]
    neighbor_mask = inputs["neighbor_mask"].to(dt)
    neighbor_weight = inputs["neighbor_weight"].to(dt)
    neighbor_distance = inputs["neighbor_distance"].to(dt)

    if cfm.feature == "atomic":
        centers = p["embed_atom/embedding"].to(dt)[atomic.long()]
    elif cfm.feature == "cgcnn":
        centers = _dense(p, "embed_atom", atomic, dt)
    else:
        raise ValueError(f"unknown feature mode: {cfm.feature}")
    if cfm.use_ring:
        ring = _dense(p, "extra_embed", inputs["ring_aromatic"], dt)
        centers = torch.cat([centers, ring], dim=-1)
    centers = swish(_dense(p, "dense_embed", centers, dt))
    if masks is not None:
        centers = (centers * masks.embed).to(centers.dtype)

    dist_c = torch.from_numpy(make_centers(cfm.gaussian_d, cfm.num_gaussian)).to(dev, dt)
    dist_rbf = gaussian_expansion(neighbor_distance, dist_c)
    if cfm.g_update:
        angle_c = torch.from_numpy(make_centers(2 * np.pi, cfm.num_gaussian)).to(dev, dt)
        d_emb = swish(_dense(p, "neighbor_d", dist_rbf, dt))
        w_emb = swish(_dense(p, "neighbor_w",
                             gaussian_expansion(neighbor_weight, angle_c), dt))
        geometry = d_emb * w_emb
    else:
        geometry = dist_rbf

    for i in range(cfm.n_attention):
        attn_mask = None if masks is None or masks.attn is None else masks.attn[i]
        centers, geometry = local_attention(
            p, f"local_attention_{i}", centers, neighbor_idx, geometry,
            neighbor_mask, neighbor_weight, cfm, attn_mask, use_pallas)
        if cfm.use_attn_norm:
            centers = residual_norm(p, f"residual_norm_{i}", centers,
                                    None if masks is None else masks.layers[i], dt)

    centers = swish(_dense(p, "after_Lc", centers, dt))
    gq = _dense(p, "global_attention/query", centers, dt)
    gk = _dense(p, "global_attention/key", centers, dt)
    segments = inputs.get("segment_onehot")
    ga_score, struc = global_attention_core(
        gq, gk, gk, atom_mask, norm=cfm.use_ga_norm,
        segment_onehot=None if segments is None else segments.to(dt))
    struc = swish(_dense(p, "bf_property", struc, dt))
    out = _dense(p, "predict_property", struc.float())
    if mrelu_head:
        out = mrelu(out)
    if segments is not None:
        out = out[..., 0]   # [B, S]
    return out, ga_score.float()


# --- L2 regularisation --------------------------------------------------------
# The reference puts Keras l2(1e-4) kernel regularizers on the q/k/v and
# filter_geo projections of every attention layer, both ResidualNorm Dense
# layers, the GA query/key, after_Lc and bf_property, but NOT on embed_atom,
# dense_embed, neighbor_d, neighbor_w, extra_embed or predict_property
# (``scann_tpu/models/scann.py:312-337``).

_REGULARIZED_LAYERS = ("query", "key", "value", "filter_geo", "dense_1", "dense_2",
                       "after_Lc", "bf_property")


def regularized_keys(params: Params) -> List[str]:
    """The kernels the l2 penalty applies to, in the params' order."""
    out = []
    for k in params:
        parts = k.split("/")
        if parts[-1] == "kernel" and any(q in _REGULARIZED_LAYERS for q in parts[:-1]):
            out.append(k)
    return out


def l2_penalty(params: Params, coeff: float = 1e-4) -> torch.Tensor:
    """Sum of the l2(coeff) kernel penalties at the reference placement."""
    keys = regularized_keys(params)
    return coeff * sum(torch.sum(params[k].float() ** 2) for k in keys)


class ScannModel(nn.Module):
    """The SCANN graph as a module that owns its parameters.

    ``params`` (flat dict, see ``param_shapes``) is used as given; without
    it the parameters are drawn with the Keras initializers from
    ``generator``."""

    def __init__(self, config: ModelConfig, mrelu_head: bool = False,
                 params: Optional[Params] = None,
                 generator: Optional[torch.Generator] = None, device="cpu",
                 use_pallas: bool = False):
        super().__init__()
        self.config = config
        self.mrelu_head = mrelu_head
        self.use_pallas = use_pallas
        if params is None:
            params = init_params(config, generator, device)
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in params.items()})

    def forward(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        pred, ga = scann_forward(dict(self.params.items()), inputs,
                                 self.config, self.mrelu_head, use_pallas=self.use_pallas)
        return {"property": pred, "ga_score": ga}
