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

``scann_forward`` is the forward as a plain function of (params, inputs):
deterministic, or the training forward when it is handed the dropout masks
of ``ops.dropout.make_dropout_masks`` (embedding and residual dropout, and
the attention dropout of ``use_drop``). ``ScannModel`` wraps it as an
``nn.Module`` that owns its parameters. ``l2_penalty`` is the reference's
kernel regularisation. Structure packing is not ported yet.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.ops.activations import mrelu, swish
from scann_tpu_torch.ops.attention import (
    gather_neighbor_states,
    global_attention_core,
    local_attention_core,
)
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


def _dense(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ params[f"{name}/kernel"] + params[f"{name}/bias"]


def _layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def local_attention(params: Params, name: str, centers, neighbor_idx,
                    geometry, neighbor_mask, neighbor_weight, cfm: ModelConfig,
                    attn_mask: Optional[torch.Tensor] = None):
    """One LocalAttention layer -> (out [B,M,D], geometry for the next
    layer). SCANN+ updates the geometry from [center | geometry | neighbor]
    as three partial products; SCANN filters the distance RBF and scales
    it by the solid angle. ``attn_mask`` [B, M, N, H] is the attention
    dropout mask (training under ``use_drop``)."""
    D = centers.shape[-1]
    ns = gather_neighbor_states(centers, neighbor_idx)
    w = params[f"{name}/filter_geo/kernel"]
    b = params[f"{name}/filter_geo/bias"]
    if cfm.g_update:
        u = ((centers @ w[0:D])[:, :, None, :]
             + geometry @ w[D:2 * D]
             + ns @ w[2 * D:3 * D]
             + b)
        geometry = _layer_norm(swish(u) + geometry,
                               params[f"{name}/layer_norm_g/scale"],
                               params[f"{name}/layer_norm_g/bias"])
        geo_term = geometry
    else:
        geo_term = swish(geometry @ w + b) * neighbor_weight[..., None]

    key = _dense(params, f"{name}/key", ns * geo_term)
    query = _dense(params, f"{name}/query", centers)
    _, ctx = local_attention_core(
        query, key, key, neighbor_mask, num_head=cfm.num_head, scale=cfm.scale,
        dropout_mask=None if attn_mask is None else attn_mask.permute(0, 3, 1, 2))
    out = _layer_norm(ctx + query, params[f"{name}/layer_norm/scale"],
                      params[f"{name}/layer_norm/bias"])
    return out, geometry


def residual_norm(params: Params, name: str, x: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Post-attention FFN block with a residual and a LayerNorm; ``mask``
    is its training dropout on the FFN output (reference ``:54-62``)."""
    h = swish(_dense(params, f"{name}/dense_1", x))
    h = _dense(params, f"{name}/dense_2", h)
    if mask is not None:
        h = h * mask
    return _layer_norm(x + h, params[f"{name}/layer_norm/scale"],
                       params[f"{name}/layer_norm/bias"])


def scann_forward(params: Params, inputs: Dict[str, torch.Tensor],
                  cfm: ModelConfig, mrelu_head: bool = False,
                  masks: Optional[DropoutMasks] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward -> (property [B, 1], ga_score [B, M, 1]), f32.

    Deterministic without ``masks``; with them, the training forward:
    dropout on the embedding (reference ``scann.py:228``), on each
    ResidualNorm's FFN output, and (``masks.attn``) on the attention
    probabilities."""
    if cfm.dtype != "float32":
        raise NotImplementedError(
            f"model.dtype={cfm.dtype!r}: the port computes in float32 only")
    p = params
    atomic = inputs["atomic"]
    dev = atomic.device
    atom_mask = inputs["atom_mask"].float()
    neighbor_idx = inputs["neighbors"]
    neighbor_mask = inputs["neighbor_mask"].float()
    neighbor_weight = inputs["neighbor_weight"].float()
    neighbor_distance = inputs["neighbor_distance"].float()

    if cfm.feature == "atomic":
        centers = p["embed_atom/embedding"][atomic.long()]
    elif cfm.feature == "cgcnn":
        centers = _dense(p, "embed_atom", atomic.float())
    else:
        raise ValueError(f"unknown feature mode: {cfm.feature}")
    if cfm.use_ring:
        ring = _dense(p, "extra_embed", inputs["ring_aromatic"].float())
        centers = torch.cat([centers, ring], dim=-1)
    centers = swish(_dense(p, "dense_embed", centers))
    if masks is not None:
        centers = centers * masks.embed

    dist_c = torch.from_numpy(make_centers(cfm.gaussian_d, cfm.num_gaussian)).to(dev)
    dist_rbf = gaussian_expansion(neighbor_distance, dist_c)
    if cfm.g_update:
        angle_c = torch.from_numpy(make_centers(2 * np.pi, cfm.num_gaussian)).to(dev)
        d_emb = swish(_dense(p, "neighbor_d", dist_rbf))
        w_emb = swish(_dense(p, "neighbor_w",
                             gaussian_expansion(neighbor_weight, angle_c)))
        geometry = d_emb * w_emb
    else:
        geometry = dist_rbf

    for i in range(cfm.n_attention):
        attn_mask = None if masks is None or masks.attn is None else masks.attn[i]
        centers, geometry = local_attention(
            p, f"local_attention_{i}", centers, neighbor_idx, geometry,
            neighbor_mask, neighbor_weight, cfm, attn_mask)
        if cfm.use_attn_norm:
            centers = residual_norm(p, f"residual_norm_{i}", centers,
                                    None if masks is None else masks.layers[i])

    centers = swish(_dense(p, "after_Lc", centers))
    gq = _dense(p, "global_attention/query", centers)
    gk = _dense(p, "global_attention/key", centers)
    ga_score, struc = global_attention_core(gq, gk, gk, atom_mask,
                                            norm=cfm.use_ga_norm)
    struc = swish(_dense(p, "bf_property", struc))
    out = _dense(p, "predict_property", struc)
    if mrelu_head:
        out = mrelu(out)
    return out, ga_score


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
                 generator: Optional[torch.Generator] = None, device="cpu"):
        super().__init__()
        self.config = config
        self.mrelu_head = mrelu_head
        if params is None:
            params = init_params(config, generator, device)
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in params.items()})

    def forward(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        pred, ga = scann_forward(dict(self.params.items()), inputs,
                                 self.config, self.mrelu_head)
        return {"property": pred, "ga_score": ga}
