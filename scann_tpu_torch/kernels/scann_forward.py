"""Whole-model SCANN forward on the GPU: the wrapper around
``csrc/scann_forward.cu``.

Replaces ``scann_tpu/kernels/scann_forward.py:_kernel`` (the Pallas TPU
kernel that runs the whole model in one program): the deterministic forward
that serving and evaluation run, and the training forward of
``kernels.scann_backward.scann_apply`` (dropout at a rate above 0, with the
Philox masks of ``ops.dropout`` that the backward replays).

- ``fused_scann_forward(params, inputs, cfm, mrelu_head, dropout_rate,
  seed)`` keeps the JAX signature and layout: (property [B, 1], ga_score
  [B, M, 1]), f32. For CUDA tensors it launches the kernel (or raises);
  for CPU tensors it runs the plain version, ``reference_scann_forward``:
  the eager model called functionally, with the same masks.
  ``fused_scann_forward.launches`` counts kernel launches
  (``.bf16_launches`` those in the bf16 operand mode, ``.d256_launches``
  those of the build of widths past 128 up to 256, ``.d512_launches``
  those of the build past 256).
- ``model.dtype: "bfloat16"`` is the bf16 operand mode of
  ``kernels/dots.py``: the kernel rounds both operands of every product to
  bfloat16 and sums in f32, as the TPU kernel's dots do, and its plain
  version is ``reference_bf16_forward``, which rounds where that kernel body
  rounds (not the eager bf16 model, which follows the flax modules' dtypes).
  Its training forward (dropout above 0) draws the same masks as in f32;
  ``reference_bf16_forward`` under ``torch.autograd`` is also the plain
  version of the backward kernels in that mode.
- Packed batches (structure packing, ``data/packing.py``): the inputs carry
  ``segment_onehot`` [B, M, S] (and, from ``Trainer._put_buckets``, the
  ``segment_ids`` [B, M] of ``ops.attention.segment_ids``, -1 on padded
  rows); the kernels launch from the ids and S, run the GA readout per
  segment and give the property [B, S], one per segment (the JAX kernels'
  [B, max(S, 1), 1] without its last axis). The plain versions run the
  eager model's segmented readout.
- The gate is the kernel's own shared-memory plan (``shared_memory_plan``)
  plus the sizes its tiles take: M <= 64 atoms, chunks of at most 64
  (atom, neighbour) rows (so N <= 64), D, G, O multiples of 4 up to 512
  (``MAX_WIDTH``). ``width_class`` names the builds a model launches: up
  to ``NARROW_WIDTH`` = 128 the first ones, up to 256 the forwards' builds
  of 8 values of a row a lane in the warp LayerNorms, sources of their own
  (``csrc/*_d256.cu``, ``library``), and up to 512 those of 16 values a
  lane (``csrc/*_d512.cu``); the chunks fall to 32 or 16 rows where 64 do
  not fit. The build of #1 past 256 columns keeps the centers alone in
  shared memory and each molecule's query and scratch rows in global memory
  (``l2_rows_shape``), so it takes QM9 (M <= 32, N = 16) at D = 512. That
  build of
  #1 runs its products on the packed TF32 planes of ``pack_params`` and
  spreads a molecule's atoms over a cluster of ``forward_cluster`` blocks
  (up to 16: the most whose B clusters the card runs at once, at least a
  chunk of atoms a block), so a small batch fills the card.
  Larger structures (crystals) go to the loop kernel (``kernels.scann_loop``).
  A packed batch adds its per-segment vectors to the plan
  (``max_segments`` is the largest S a shape takes, at most
  ``MAX_SEGMENTS``).
- The launch wrappers (``launch_scann_forward`` and the other kernels'
  ``launch_*``) check shapes, dtypes and devices from the tensors' metadata
  and read nothing back. The batch's index ranges are checked where data
  enters (``models.scann.check_index_ranges``: ``Trainer`` per bucket on
  the host, ``Scann.forward_eval`` per batch) and by the wrappers with the
  JAX signature (``fused_scann_forward`` and its kin) before they launch.

Bound and design are in the source note of ``csrc/scann_forward.cu``:
about 5.0e10 FLOP per QM9 batch (B=128, M=32, N=16, L=7, D=128), so it is
bound by operations (~0.31 ms as three TF32 passes per product at the H100
SXM's dense 495 TFLOP/s, ``forward_fp32_flops`` at 67 TFLOP/s FP32); one
block per molecule, products as split-TF32 ``mma.sync`` on the tensor cores
at f32 accuracy, the SCANN+ geometry in a global scratch buffer.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from scann_tpu_torch.config import ModelConfig, attn_dropout_rate
from scann_tpu_torch.kernels import dots
from scann_tpu_torch.kernels import widths
from scann_tpu_torch.kernels.widths import MAX_WIDTH, NARROW_WIDTH
from scann_tpu_torch.models.scann import CGCNN_FEATURES, check_index_ranges, scann_forward
from scann_tpu_torch.ops.activations import mrelu, swish
from scann_tpu_torch.ops.attention import gather_neighbor_states, segment_ids
from scann_tpu_torch.ops.dropout import (
    DropoutMasks,
    keep_scale,
    keep_threshold,
    make_dropout_masks,
)
from scann_tpu_torch.ops.rbf import gaussian_expansion, make_centers

REPLACES = "scann_tpu/kernels/scann_forward.py:222"  # _kernel
SOURCE = "scann_tpu_torch/csrc/scann_forward.cu"
MAX_ATOMS = 64
MAX_CHUNK_ROWS = 64
MAX_NEIGHBORS = 256   # kernels #3, #5 and #4 in their wide builds (kWideMaxN)
# D, G and O up to MAX_WIDTH = 512 in the forwards #1, #3 and #5; past
# NARROW_WIDTH their *_d256 builds, past 256 their *_d512 ones: ``width_class``
# the forward's chunks of (atom, neighbour) rows, the first whose plan fits
# (64 fits at every width up to 128; 32 at QM9 at D = 256, 16 at D = 512)
CHUNK_ROWS = (64, 32, 16)
MAX_SHARED_BYTES = 232448  # 227 KB per block on sm_90
MAX_SEGMENTS = 32          # kMaxSegments of csrc/scann_common.cuh
# Blocks a molecule #1's build past 128 columns may launch with
# (kMaxForwardCluster of csrc/scann_forward.cu; past 8 a non-portable size):
# ``forward_cluster`` takes the largest whose B clusters the card runs at
# once, at most one a chunk of atoms.
FORWARD_CLUSTER_SIZES = tuple(range(16, 0, -1))
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
    kernels' dropout masks at a rate above 0; in the bf16 operand mode
    ``reference_bf16_forward`` with the segment pools exact."""
    masks = dropout_masks_for(cfm, inputs, dropout_rate, seed, mol_base)
    if cfm.dtype == "bfloat16":
        return reference_bf16_forward(params, inputs, cfm, mrelu_head, True, masks)
    return scann_forward(params, inputs, cfm, mrelu_head, masks)


def _pools(seg: Optional[torch.Tensor], exact: bool):
    """(pool, rows) of the GA readout: the sums over a structure's atoms and
    their broadcast back to its rows. Unpacked the atom axis's sum and the
    identity; packed the products with the [B, M, S] one-hot, f32-exact
    (the molecule kernel) or as bf16-mode products (the loop kernel)."""
    if seg is None:
        return (lambda x: x.sum(dim=1, keepdim=True)), (lambda y: y)
    if exact:
        return (lambda x: dots.mm_tA_hi(seg, x)), (lambda y: dots.mm_hi(seg, y))
    mm, mm_tA = dots.dot_fns(True)[:2]
    return (lambda x: mm_tA(seg, x)), (lambda y: mm(seg, y))


class _Readout(torch.autograd.Function):
    """The GA readout of the bf16 plain versions, from the GA queries and
    keys [B, M, G] to (ga [B, M, 1], the pooled rows struc [B, G], or [B, S,
    G] for a packed batch), whose backward is the TPU kernels' own
    (``scann_backward.py:359-398``, ``scann_loop.py:692-714``): it rounds
    where their pools round, and the softmax's shift takes no gradient."""

    @staticmethod
    def forward(ctx, gq, gk, am, seg, ga_norm, exact):
        pool, rows = _pools(seg, exact)
        mq, mk = am * gq, am * gk
        qrows = rows(pool(mq))
        agg0 = am * ((mk * qrows).sum(-1, keepdim=True) - (mk * mq).sum(-1, keepdim=True))
        agg, nrm = agg0, None
        if ga_norm:
            nrm = rows(torch.sqrt(pool(agg0 * agg0)))
            nrm = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
            agg = agg0 / nrm
        agg = agg + (1.0 - am) * -1e9
        if seg is None:
            e = torch.exp(agg - agg.amax(dim=1, keepdim=True))
            ga = e / e.sum(dim=1, keepdim=True)
            struc = (am * ga * gk).sum(dim=1)                              # [B, G]
        else:
            if exact:        # the slot's max: constant within each segment
                e = torch.exp(agg - agg.amax(dim=1, keepdim=True))
            else:            # each segment's own max, as a bf16-mode product
                segmax = (agg + (seg - 1.0) * 1e9).amax(dim=1, keepdim=True)   # [B, 1, S]
                e = torch.exp(agg - dots.dot_fns(True)[2](seg, segmax)) * am
            den = rows(pool(e))
            ga = e / torch.where(den == 0, torch.ones_like(den), den)
            struc = pool(ga * mk if exact else am * ga * gk)               # [B, S, G]
        ctx.save_for_backward(gk, am, seg, mq, mk, qrows, agg0, nrm, ga)
        ctx.ga_norm, ctx.exact = ga_norm, exact
        return ga, struc

    @staticmethod
    def backward(ctx, dga_in, dstruc):
        gk, am, seg, mq, mk, qrows, agg0, nrm, ga = ctx.saved_tensors
        pool, rows = _pools(seg, ctx.exact)
        ds = dstruc[:, None, :] if seg is None else rows(dstruc)
        dga = (am * gk * ds).sum(-1, keepdim=True)
        if dga_in is not None:
            dga = dga + dga_in
        dgk = am * ga * ds
        dagg = ga * (dga - rows(pool(ga * dga)))
        if ctx.ga_norm:
            dagg = dagg / nrm - agg0 * (rows(pool(agg0 * dagg)) / (nrm * nrm * nrm))
        dcd = dagg * am
        dmk = dcd * qrows - dcd * mq
        dmq = -dcd * mk + rows(pool(dcd * mk))
        return am * dmq, dgk + am * dmk, None, None, None, None


def reference_bf16_forward(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                           cfm: ModelConfig, mrelu_head: bool = False,
                           exact_pools: bool = True, masks: Optional[DropoutMasks] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole-model forward in the bf16 operand mode -> (property [B, 1]
    or [B, S] for a packed batch, ga_score [B, M, 1]), f32: the arithmetic of
    ``scann_tpu/kernels/scann_forward.py:_kernel`` and ``scann_loop.py:_fwd_kernel``
    with ``dots.dot_fns(True)``. Every product rounds both operands to
    bfloat16, also those the port does not form as products: the neighbour
    gather (a one-hot product there, so the gathered states are rounded
    centers), the energies (each q * k lane rounded before the head sum),
    the attention expanded to lanes (rounded), the embedding lookup (the
    rounded table row) and the head. A packed batch pools its segments
    f32-exact with ``exact_pools`` (the molecule kernel's ``mm_hi``,
    ``scann_forward.py:375-379``) or as bf16-mode products with the loop
    kernel's per-segment max shift (``scann_loop.py:367-395``). ``masks``
    (``dropout_masks_for``) is the training dropout: the embedding, each
    layer's attention before its lane expansion and its ResidualNorm FFN
    output. The arithmetic between the roundings is in the params' dtype:
    f32, or f64 to measure how far f32 sums alone move the result.

    Differentiated by ``torch.autograd`` it is the plain version of the
    backward kernels in that mode (``scann_backward.py:_kernel``,
    ``scann_loop.py:_bwd_kernel``): its products are ``dots.product`` and
    ``dots.one_hot``, which round the cotangent where those kernels round
    it, and the readout is ``_Readout``."""
    return whole_model_forward(params, inputs, cfm, mrelu_head, exact_pools, masks, True)


def _ln_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6):
    """(LayerNorm(x), x-hat, rsqrt(var + eps)), as the TPU kernels' _ln_fwd."""
    mu = x.mean(-1, keepdim=True)
    inv = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + eps)
    xhat = (x - mu) * inv
    return xhat * gamma + beta, xhat, inv


def layer_weights(params: Dict[str, torch.Tensor], l: int,
                  g_update: bool) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s LocalAttention/ResidualNorm params under the kernels'
    names (``_LAYER_KEYS``, then ``lng_s``/``lng_b`` for SCANN+)."""
    w = {name: params[key.format(l)] for name, key in _LAYER_KEYS}
    if g_update:
        w["lng_s"] = params[f"local_attention_{l}/layer_norm_g/scale"]
        w["lng_b"] = params[f"local_attention_{l}/layer_norm_g/bias"]
    return w


class AttentionLayer:
    """One attention layer of a batch as the TPU kernels' layer_fwd computes
    it (LocalAttention, then ResidualNorm), in the operand mode ``bf16``:
    the inputs' neighbour indices, masks and weights, the RBF of the
    distances and the layer's dropout masks. In the bf16 mode its products
    are ``dots.product`` and ``dots.one_hot``, so under ``torch.autograd``
    they round the cotangent where the TPU backward kernels do; in f32 they
    are plain products and maps. The one plain body of the layer: the
    whole-model forward runs it, and the plain versions of the activation
    stashes take its acts."""

    def __init__(self, inputs: Dict[str, torch.Tensor], cfm: ModelConfig,
                 masks: Optional[DropoutMasks], l: int, rbf_d: torch.Tensor, bf16: bool):
        B, M = inputs["atomic"].shape[:2]
        ft = rbf_d.dtype
        self.cfm, self.rbf_d, self.bf16 = cfm, rbf_d, bf16
        self.nbr = inputs["neighbors"]
        self.nmask = inputs["neighbor_mask"].to(ft)
        self.weight = inputs["neighbor_weight"].to(ft)
        self.D, self.H = cfm.local_dim, cfm.num_head
        self.hd = self.D // self.H
        self.dk = attention_scale(cfm)
        self.res_mask = masks.layers[l] if masks is not None else None
        self.amask = masks.attn[l] if masks is not None and masks.attn is not None else None
        self.r = dots.round_bf16 if bf16 else (lambda x: x)
        if bf16:
            self.mm, self.one_hot = dots.product, dots.one_hot
        else:
            self.mm, self.one_hot = (lambda a, w: a @ w), (lambda x, fwd, bwd: fwd(x))
        self.rows = (self.nbr.long() + M * torch.arange(B, device=self.nbr.device)[:, None, None]
                     ).reshape(-1)

    def _lanes(self, x):         # x @ seg_expand: [.., H] -> [.., D]
        return x.repeat_interleave(self.hd, dim=-1)

    def _head_sum(self, x):      # x @ seg_sum: [.., D] -> [.., H]
        return x.unflatten(-1, (self.H, self.hd)).sum(-1)

    def scatter(self, dns):      # n_oh^T @ dns: each neighbour row into its atom
        B, M = dns.shape[:2]
        return dns.new_zeros(B * M, self.D).index_add_(
            0, self.rows, dns.reshape(-1, self.D)).view(B, M, self.D)

    def lanes(self, x):
        return self.one_hot(x, self._lanes, self._head_sum)

    def head_sum(self, x):
        return self.one_hot(x, self._head_sum, self._lanes)

    def gather(self, c):         # n_oh @ c
        return self.one_hot(c, lambda t: gather_neighbor_states(t, self.nbr), self.scatter)

    def forward(self, w: Dict[str, torch.Tensor], c: torch.Tensor, g: Optional[torch.Tensor]):
        """(c_out, g_out, acts) for the layer weights ``w``
        (``layer_weights``), centers ``c`` and, for SCANN+, geometry ``g``."""
        mm, D = self.mm, self.D
        ns = self.gather(c)
        if self.cfm.g_update:
            wfg = w["wfg"]
            u_pre = (mm(c, wfg[:D])[:, :, None, :] + mm(g, wfg[D:2 * D])
                     + mm(ns, wfg[2 * D:]) + w["bfg"])
            g_out, g_xhat, g_inv = _ln_fwd(swish(u_pre) + g, w["lng_s"], w["lng_b"])
            geo_term = g_out
        else:
            u_pre = mm(self.rbf_d, w["wfg"]) + w["bfg"]
            geo_term = swish(u_pre) * self.weight[..., None]
            g_out, g_xhat, g_inv = g, None, None
        key = mm(ns * geo_term, w["wk"]) + w["bk"]
        query = mm(c, w["wq"]) + w["bq"]
        energy = self.head_sum((query * self.dk)[:, :, None, :] * key)
        energy = energy + (1.0 - self.nmask)[..., None] * -1e9
        e = torch.exp(energy - energy.amax(dim=2, keepdim=True).detach())
        attn = e / e.sum(dim=2, keepdim=True)
        attn_used = attn * self.amask if self.amask is not None else attn
        ctx = (self.lanes(attn_used) * self.nmask[..., None] * key).sum(dim=2)
        o1, o_xhat, o_inv = _ln_fwd(ctx + query, w["ln_s"], w["ln_b"])
        s1 = mm(o1, w["wr1"]) + w["br1"]
        h1 = swish(s1)
        h2 = mm(h1, w["wr2"]) + w["br2"]
        if self.res_mask is not None:
            h2 = h2 * self.res_mask
        c_out, c_xhat, c_inv = _ln_fwd(o1 + h2, w["rln_s"], w["rln_b"])
        acts = dict(ns=ns, u_pre=u_pre, geo_term=geo_term, g_xhat=g_xhat, g_inv=g_inv, key=key,
                    query=query, attn=attn, attn_used=attn_used, o1=o1, o_xhat=o_xhat,
                    o_inv=o_inv, s1=s1, h1=h1, c_xhat=c_xhat, c_inv=c_inv)
        return c_out, g_out, acts


def whole_model_forward(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                        cfm: ModelConfig, mrelu_head: bool, exact_pools: bool,
                        masks: Optional[DropoutMasks], bf16: bool, layer=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The body of ``reference_bf16_forward``; with ``bf16`` False the same
    arithmetic in f32 (plain products, segment pools f32-exact). Each
    attention layer is ``layer(l, centers, geometry, rbf_d) -> (centers,
    geometry)`` (geometry None for SCANN): ``AttentionLayer.forward`` by
    default; the plain versions of the backward kernels' activation stashes
    pass a hook that runs the same body under their own layer backward."""
    if bf16:
        mm, one_hot = dots.product, dots.one_hot
    else:
        mm, one_hot = (lambda a, w: a @ w), (lambda x, fwd, bwd: fwd(x))
        exact_pools = True
    p = params
    ft = p["dense_embed/kernel"].dtype
    atomic = inputs["atomic"]
    dev = atomic.device
    am = inputs["atom_mask"].to(ft)                      # [B, M, 1]

    if cfm.feature == "cgcnn":
        emb = mm(atomic.to(ft), p["embed_atom/kernel"]) + p["embed_atom/bias"]
    else:                                                # one-hot @ table
        z = atomic.long()
        emb = one_hot(p["embed_atom/embedding"], lambda t: t[z],
                      lambda g: g.new_zeros(p["embed_atom/embedding"].shape).index_add_(
                          0, z.reshape(-1), g.reshape(-1, g.shape[-1])))
    de_w = p["dense_embed/kernel"]
    s_de = mm(emb, de_w[:cfm.embedding_dim]) + p["dense_embed/bias"]
    if cfm.use_ring:
        ring = mm(inputs["ring_aromatic"].to(ft), p["extra_embed/kernel"]) + p["extra_embed/bias"]
        s_de = s_de + mm(ring, de_w[cfm.embedding_dim:])
    centers = swish(s_de)
    if masks is not None:
        centers = centers * masks.embed

    dist_c = torch.from_numpy(make_centers(cfm.gaussian_d, cfm.num_gaussian)).to(dev)
    rbf_d = gaussian_expansion(inputs["neighbor_distance"].to(ft), dist_c, RBF_WIDTH)
    geometry = None
    if cfm.g_update:
        angle_c = torch.from_numpy(make_centers(2 * np.pi, cfm.num_gaussian)).to(dev)
        rbf_w = gaussian_expansion(inputs["neighbor_weight"].to(ft), angle_c, RBF_WIDTH)
        geometry = (swish(mm(rbf_d, p["neighbor_d/kernel"]) + p["neighbor_d/bias"])
                    * swish(mm(rbf_w, p["neighbor_w/kernel"]) + p["neighbor_w/bias"]))

    if layer is None:
        def layer(l, centers, geometry, rbf_d):
            c, g, _ = AttentionLayer(inputs, cfm, masks, l, rbf_d, bf16).forward(
                layer_weights(p, l, cfm.g_update), centers, geometry)
            return c, g

    for l in range(cfm.n_attention):
        centers, geometry = layer(l, centers, geometry, rbf_d)

    centers = swish(mm(centers, p["after_Lc/kernel"]) + p["after_Lc/bias"])
    gq = mm(centers, p["global_attention/query/kernel"]) + p["global_attention/query/bias"]
    gk = mm(centers, p["global_attention/key/kernel"]) + p["global_attention/key/bias"]
    seg = inputs.get("segment_onehot")
    ga, struc = _Readout.apply(gq, gk, am, None if seg is None else seg.to(ft),
                               cfm.use_ga_norm, exact_pools)
    struc = swish(mm(struc, p["bf_property/kernel"]) + p["bf_property/bias"])
    pred = mm(struc, p["predict_property/kernel"]) + p["predict_property/bias"]
    if mrelu_head:
        pred = mrelu(pred)
    return (pred if seg is None else pred[..., 0]), ga


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
    ws = [layer_weights(params, i, g_update) for i in range(n_layers)]
    return {name: torch.stack([w[name] for w in ws]) for name in ws[0]}


def _r4(x: int) -> int:
    return -(-x // 4) * 4


def forward_chunk_floats(rows: int, D: int, H: int) -> int:
    """Floats of a chunk of (atom, neighbour) rows in the forward kernels
    (``fwd_chunk_floats`` of ``csrc/scann_forward_common.cuh``): the operand
    [rows, 2D + 4], the product [rows, D + 4], the attention [rows, H]."""
    return rows * (2 * D + 4) + rows * (D + 4) + _r4(rows * H)


def embedding_stage_floats(cfm: ModelConfig, atoms: int) -> int:
    """Floats of the embedding's staging of ``atoms`` atoms: [atoms, lde]
    (embedding and ring columns) and, for cgcnn, [atoms, ldf] (features)."""
    lde = _r4(cfm.embedding_dim + (10 if cfm.use_ring else 0))
    ldf = _r4(CGCNN_FEATURES) if cfm.feature == "cgcnn" else 0
    return atoms * (lde + ldf)


def seg_forward_floats(S: int, ld: int, M: int, O: int) -> int:
    """Floats of the forward kernels' per-segment readout vectors
    (``seg_forward_floats`` of ``csrc/scann_common.cuh``): qsum and the
    pooled rows [S, ld], agg0, ga and diag [M], norm and sum [S], the
    head's [O]."""
    return 2 * S * ld + 3 * _r4(M) + 2 * _r4(S) + _r4(O)


def seg_backward_floats(S: int, ld: int, M: int, O: int) -> int:
    """Floats of the backward kernels' per-segment readout vectors
    (``seg_backward_floats`` of ``csrc/scann_common.cuh``): qsum, the pooled
    rows and their gradient [S, ld]; five [M]; four [S]; three [O]."""
    return 3 * S * ld + 5 * _r4(M) + 4 * _r4(S) + 3 * _r4(O)


def shared_memory_plan(cfm: ModelConfig, M: int, N: int, S: int = 0) -> Tuple[int, int, int]:
    """(atoms per chunk of rows, floats of the work region, shared bytes per
    block) -- the layout ``make_plan`` in the CUDA source walks: centers,
    query and a scratch [M, max(D, G) + 4] each (past 256 columns the
    centers alone: the build keeps the other two in ``l2_rows_shape``), the
    work region (a chunk's buffers or the embedding's staging), the
    readout's vectors (per segment for a packed batch of S segments a slot).
    The chunk is the first of ``CHUNK_ROWS`` rows (whole atoms, at least
    one) whose plan fits, else the first's plan."""
    D, G, O, H = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.num_head
    ldm = max(D, G) + 4
    resident = 1 if width_class(cfm) > 256 else 3
    misc = seg_forward_floats(S, ldm, M, O) if S else 2 * ldm + _r4(M) + _r4(O)
    plans = []
    for rows in CHUNK_ROWS:
        chunk_atoms = max(1, min(M, rows // N))
        work = max(forward_chunk_floats(chunk_atoms * N, D, H), embedding_stage_floats(cfm, M))
        plans.append((chunk_atoms, work, 4 * (resident * M * ldm + work + misc)))
        if plans[-1][2] <= MAX_SHARED_BYTES:
            return plans[-1]
    return plans[0]


def width_constants(cfm: ModelConfig) -> widths.WidthClass:
    """The row of ``kernels.widths`` of the largest of the model's D, G and
    O: its class, its builds' suffix and the constants their plans mirror."""
    return widths.class_of(max(cfm.local_dim, cfm.global_dim, cfm.dense_out))


def width_class(cfm: ModelConfig) -> int:
    """The width class of the model (``width_constants``): 128
    (``NARROW_WIDTH``), whose launches take the builds that always were;
    256, the builds of ``csrc/*_d256.cu`` (8 values of a row a lane in the
    warp LayerNorms); 512, those of ``csrc/*_d512.cu`` (16 values a lane).
    Every choice of a build of the forwards #1, #3 and #5 and of the loop
    backward #4 reads it."""
    return width_constants(cfm).width


def library(cfm: ModelConfig) -> str:
    """The build of #1 that launches the config's batches, the name of its
    library and its entry points' prefix: ``scann_forward`` with the width
    class's suffix (``scann_forward_d256``, ``scann_forward_d512``)."""
    return "scann_forward" + width_constants(cfm).suffix


def l2_rows_shape(cfm: ModelConfig, B: int, M: int) -> Optional[Tuple[int, int, int, int]]:
    """The query and scratch rows of each molecule that #1's build past 256
    columns keeps in global memory (launch pointer 51), [B, 2, M, max(D, G)
    + 4]; None for the other builds, which keep them in shared memory."""
    if width_class(cfm) <= 256:
        return None
    return (B, 2, M, max(cfm.local_dim, cfm.global_dim) + 4)


def segment_count(inputs: Dict[str, torch.Tensor]) -> int:
    """S of a packed batch (its ``segment_onehot`` [B, M, S]), 0 for an
    unpacked one."""
    seg = inputs.get("segment_onehot")
    return 0 if seg is None else int(seg.shape[-1])


def segment_refusal(S: int) -> Optional[str]:
    """What every whole-model kernel refuses of a packed batch."""
    if S > MAX_SEGMENTS:
        return (f"S={S} segments a slot: the whole-model kernels take at most "
                f"{MAX_SEGMENTS} (tpu.pack_max_segments)")
    return None


def largest_segments(plan_bytes) -> int:
    """The largest S <= MAX_SEGMENTS with ``plan_bytes(S)`` within a
    block's shared memory (0 where none is)."""
    return max([S for S in range(1, MAX_SEGMENTS + 1) if plan_bytes(S) <= MAX_SHARED_BYTES],
               default=0)


def max_segments(cfm: ModelConfig, M: int, N: int) -> int:
    """The largest S a packed batch of shape (M, N) may have here."""
    return largest_segments(lambda S: shared_memory_plan(cfm, M, N, S)[2])


def refusal(cfm: ModelConfig, M: int, N: int, S: int = 0) -> Optional[str]:
    """Why the kernel does not take (config, M, N) at S segments a slot (0:
    unpacked), or None where it does: the gate, read by ``check_supported``
    and by the dispatch in ``Trainer.eval_route``."""
    if M > MAX_ATOMS:
        return (f"M={M} atoms: the whole-model kernel takes M <= {MAX_ATOMS}; "
                "larger structures go to the crystal loop kernel (kernels.scann_loop)")
    if not cfm.use_attn_norm:
        return ("use_attn_norm=False: the kernel always applies ResidualNorm; "
                "that configuration runs in the per-layer model "
                "(models.scann.scann_forward with use_pallas)")
    reason = common_refusal(cfm, N) or segment_refusal(S)
    nbytes = 0 if reason else shared_memory_plan(cfm, M, N, S)[2]
    if nbytes > MAX_SHARED_BYTES:
        reason = f"shared-memory plan of {nbytes} bytes exceeds {MAX_SHARED_BYTES}"
        if S:
            reason += (f" at S={S} segments a slot (this shape takes up to "
                       f"{max_segments(cfm, M, N)})")
    return reason


def common_refusal(cfm: ModelConfig, N: int, max_n: int = MAX_CHUNK_ROWS,
                   max_width: int = MAX_WIDTH) -> Optional[str]:
    """What the whole-model kernels refuse: a dtype other than float32 and
    bfloat16 (the bf16 operand mode) and sizes outside the tiles of
    ``csrc/scann_common.cuh``, with N up to ``max_n`` (#1: one chunk of
    rows; the loop kernels #3 and #4: ``MAX_NEIGHBORS``) and D, G, O up to
    ``max_width`` (the forwards and the loop backward #4: ``MAX_WIDTH``; the
    molecule backward #2 keeps ``kernels.scann_backward.MAX_WIDTH``)."""
    if cfm.dtype not in ("float32", "bfloat16"):
        return (f"model.dtype={cfm.dtype!r}: the kernels take float32 and bfloat16 (the "
                "bf16 operand mode)")
    D, G, O, E = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.embedding_dim
    if (N < 1 or N > max_n or any(x % 4 or x > max_width for x in (D, G, O))
            or E % 4 or D % cfm.num_head or cfm.num_gaussian > D):
        return (f"sizes outside the kernel's tiles: N={N} (<= {max_n}), "
                f"D={D}, G={G}, O={O} (multiples of 4, <= {max_width}), E={E} "
                f"(multiple of 4), D % num_head == 0, num_gaussian <= D")
    return None


def check_supported(cfm: ModelConfig, M: int, N: int, S: int = 0) -> None:
    """Raise NotImplementedError for what the kernel does not take."""
    reason = refusal(cfm, M, N, S)
    if reason:
        raise NotImplementedError(reason)


def tf32_planes(w: torch.Tensor) -> torch.Tensor:
    """The packed TF32 planes of a weight [..., R, C] -> [..., n], in the
    order ``mma_gemm_w32`` of ``csrc/scann_mma.cuh`` reads them. Three
    planes: hi, w rounded to TF32 as ``split_tf32`` rounds it (half a TF32
    ulp added to the bits, the 13 low bits cleared), lo = w - hi (exact, so
    hi + lo == w), and w rounded to bfloat16 (the bf16 operand mode's
    operand). R and C are padded with zeros to multiples of 32; for each
    group G of 32 columns and each half s of each step of 32 rows come 12
    float4s a lane (plane p's row 32 (s // 2) + 8t + 4 (s % 2) + i at its
    columns 32G + 4g .. + 3, lane 4g + t, as q = 4p + i), the lanes side by
    side: [..., G, s, q, lane, 4]. The 32-column products of every forward
    build past 128 columns read them (#1, the tall and wide #3, the narrow
    and wide #5): each weight split once where it is packed, with the bits a
    split at use gives."""
    w = w.detach().to(torch.float32)
    *lead, R, C = w.shape
    w = torch.nn.functional.pad(w, (0, -C % 32, 0, -R % 32)).contiguous()
    hi = ((w.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    p = torch.stack([hi, w - hi, w.to(torch.bfloat16).to(torch.float32)], dim=-3)
    n = len(lead)
    # [plane, s2, t, h, i, G, g, j] -> [G, s2, h, plane, i, g, t, j]
    p = p.reshape(*lead, 3, p.shape[-2] // 32, 4, 2, 4, p.shape[-1] // 32, 8, 4)
    p = p.permute(*range(n), *(n + a for a in (5, 1, 3, 0, 4, 6, 2, 7)))
    return p.reshape(*lead, -1).contiguous()


def unpack_tf32_planes(p: torch.Tensor, R: int, C: int) -> torch.Tensor:
    """The three planes [..., 3, R, C] of ``tf32_planes`` output for a
    weight [..., R, C] (the inverse of its packing)."""
    lead = p.shape[:-1]
    n = len(lead)
    Rp, Cp = R + -R % 32, C + -C % 32
    q = p.reshape(*lead, Cp // 32, Rp // 32, 2, 3, 4, 8, 4, 4)
    # [G, s2, h, plane, i, g, t, j] -> [plane, s2, t, h, i, G, g, j]
    q = q.permute(*range(n), *(n + a for a in (3, 1, 6, 2, 4, 0, 5, 7)))
    return q.reshape(*lead, 3, Rp, Cp)[..., :R, :C]


def layer_tf32_planes(wfg: torch.Tensor, wk: torch.Tensor, wq: torch.Tensor,
                      g_update: bool) -> torch.Tensor:
    """``tf32_planes`` of one layer's products (or of [L, ...] stacked
    layers) one after the other, as ``row_planes`` of
    ``csrc/scann_forward_common.cuh`` finds them: Wfg[0:D] (cw) and
    Wfg[D:3D] for SCANN+, Wfg for SCANN, then Wk and Wq."""
    D = wk.shape[-1]
    blocks = ([wfg[..., :D, :], wfg[..., D:, :]] if g_update else [wfg]) + [wk, wq]
    return torch.cat([tf32_planes(b) for b in blocks], dim=-1)


def pack_params(params: Dict[str, torch.Tensor], cfm: ModelConfig) -> Dict[str, torch.Tensor]:
    """Everything the kernel reads besides the batch: stacked layer params,
    the other weights, the RBF centers; contiguous f32 on the params' device.
    Past 128 columns (``width_class``) also each layer's ``layer_tf32_planes``
    followed by the ``tf32_planes`` of its ResidualNorm's W1 and W2, [L, n]
    ("tf32_planes"), which #1 (launch pointer 50) and the tall and wide #3
    (pointer 52) read there."""
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
    if width_class(cfm) > NARROW_WIDTH:
        p["tf32_planes"] = torch.cat([layer_tf32_planes(p["wfg"], p["wk"], p["wq"], cfm.g_update),
                                      tf32_planes(p["wr1"]), tf32_planes(p["wr2"])], dim=-1)
    return p


_INPUT_KEYS = ("atomic", "feat", "atom_mask", "neighbors", "neighbor_mask",
               "neighbor_weight", "neighbor_distance", "ring_aromatic")
_PARAM_KEYS = ("dist_centers", "angle_centers", "embed", "bembed", "wring", "bring",
               "wde", "bde", "wnd", "bnd", "wnw", "bnw",
               "wfg", "bfg", "wk", "bk", "wq", "bq", "ln_s", "ln_b", "lng_s", "lng_b",
               "wr1", "br1", "wr2", "br2", "rln_s", "rln_b",
               "wal", "bal", "wgq", "bgq", "wgk", "bgk", "wbf", "bbf", "wp", "bp")


def _check_shapes(inputs: Dict[str, torch.Tensor], cfm: ModelConfig,
                  dev: torch.device) -> Tuple[int, int, int]:
    """Shapes, dtypes, devices and contiguity of a batch, read from the
    tensors' metadata (nothing is read back) -> (B, M, N)."""
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
    S = segment_count(inputs)
    if S:
        want["segment_onehot"] = ((B, M, S), torch.float32)
        if "segment_ids" in inputs:
            want["segment_ids"] = ((B, M), torch.int32)
    for k, (shape, dtype) in want.items():
        t = inputs[k]
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"input {k!r}: expected a contiguous {dtype} tensor of shape {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    return B, M, N


def _check_inputs(inputs: Dict[str, torch.Tensor], cfm: ModelConfig,
                  dev: torch.device) -> Tuple[int, int, int]:
    """``_check_shapes`` and the index ranges (``check_index_ranges``, a
    read-back of the tensors) -> (B, M, N): what a direct caller checks."""
    out = _check_shapes(inputs, cfm, dev)
    check_index_ranges(inputs, cfm)
    return out


def launch_scann_forward(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                         cfm: ModelConfig, mrelu_head: bool = False,
                         dropout_rate: float = 0.0, seed: int = 0, mol_base: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check CUDA inputs' shapes and launch the kernel with ``pack_params``
    output; nothing is read back, so the batch's index ranges are the
    caller's to check (``check_index_ranges``)."""
    dev = packed["wde"].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    _check_shapes(inputs, cfm, dev)
    return _launch(packed, inputs, cfm, mrelu_head, dropout_rate, seed, mol_base)


def launch_arguments(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                     cfm: ModelConfig, mrelu_head: bool, dropout_rate: float, seed: int,
                     mol_base: int, chunk_atoms: int, work: int,
                     geo: Optional[torch.Tensor] = None):
    """What the whole-model forwards (this kernel and the crystal loop
    kernel) are launched with: (tensors in ``unpack_forward_args`` order,
    the outputs and the SCANN+ geometry scratch last; sizes, with the plan's
    chunk atoms and work floats; scalars; random-stream words), and the
    outputs (pred [B], or [B * S] for a packed batch of S segments a slot;
    ga [B, M]). ``geo`` is the [B * M * N * D] geometry scratch (SCANN+),
    allocated here when None."""
    dev = packed["wde"].device
    B, M = inputs["atomic"].shape[:2]
    N = inputs["neighbors"].shape[2]
    D = cfm.local_dim
    cgcnn = cfm.feature == "cgcnn"
    pred = torch.empty(B * max(segment_count(inputs), 1), device=dev, dtype=torch.float32)
    ga = torch.empty((B, M), device=dev, dtype=torch.float32)
    if cfm.g_update and geo is None:
        geo = torch.empty(B * M * N * D, device=dev, dtype=torch.float32)
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
            int(mrelu_head), chunk_atoms, work]
    flags, scales, words = rng_words(cfm, dropout_rate, seed, mol_base)
    return order, dims + flags, [attention_scale(cfm), RBF_WIDTH, *scales], words, pred, ga


def segment_arguments(inputs: Dict[str, torch.Tensor]) -> Tuple[Optional[torch.Tensor], int]:
    """(segment ids [B, M] int32, S) a whole-model kernel launches a packed
    batch with, (None, 0) for an unpacked one: the batch's ``segment_ids``
    where ``Trainer._put_buckets`` put them, else computed on the device
    from its ``segment_onehot`` (nothing is read back)."""
    S = segment_count(inputs)
    if not S:
        return None, 0
    ids = inputs.get("segment_ids")
    if ids is None:
        ids = segment_ids(inputs["segment_onehot"])
    return ids.contiguous(), S


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


def chunk_count(cfm: ModelConfig, M: int, N: int, S: int = 0) -> int:
    """The chunks of atoms of a molecule in the plan (``shared_memory_plan``):
    the most blocks a molecule of #1's build past 128 columns may take."""
    return -(-M // shared_memory_plan(cfm, M, N, S)[0])


def launch_dims(cfm: ModelConfig, B: int, M: int, N: int, S: int = 0) -> list:
    """The launch's sizes that its plan and its cluster's occupancy read (the
    others 0): those of ``launch_arguments``, then S and the operand mode."""
    chunk_atoms, work, _ = shared_memory_plan(cfm, M, N, S)
    return [B, M, N, cfm.local_dim, cfm.num_head, cfm.embedding_dim, cfm.num_gaussian,
            cfm.global_dim, cfm.dense_out, cfm.n_attention, CGCNN_FEATURES,
            int(cfm.feature == "cgcnn"), int(cfm.use_ring), int(cfm.g_update), 0, 0,
            chunk_atoms, work, 0, 0, S, operand_mode(cfm)]


def cluster_answer(library: str, symbol: str, dims: list, cluster: int) -> int:
    """``<symbol>_max_clusters`` of the build ``library`` at a launch's sizes
    ``dims``: how many clusters of ``cluster`` blocks the card runs at once
    (``cudaOccupancyMaxActiveClusters``). Each entry point keeps its
    answers, so a launch asks the card once a shape."""
    from scann_tpu_torch.kernels._build import load_library

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


def max_active_clusters(cfm: ModelConfig, B: int, M: int, N: int, cluster: int,
                        S: int = 0) -> int:
    """How many clusters of ``cluster`` blocks of #1's build past 128
    columns at this shape the card runs at once, in the launch's operand
    mode (``cluster_answer``)."""
    return cluster_answer(library(cfm), library(cfm), launch_dims(cfm, B, M, N, S), cluster)


def forward_cluster(cfm: ModelConfig, B: int, M: int, N: int, S: int = 0) -> int:
    """Thread blocks a molecule of a launch: past 128 columns (``width_class``)
    the largest of ``FORWARD_CLUSTER_SIZES`` with at least a chunk of atoms
    a block (``chunk_count``) whose B clusters the card runs at once
    (``max_active_clusters``: 16 for a lone QM9 molecule, 6 at B = 16 on a
    card that runs 17 clusters of 6, 1 at the batch of 128); the build up to
    128 columns launches one."""
    if width_class(cfm) == NARROW_WIDTH:
        return 1
    most = chunk_count(cfm, M, N, S)
    for C in FORWARD_CLUSTER_SIZES:
        if C <= most and B <= max_active_clusters(cfm, B, M, N, C, S):
            return C
    return 1


def _launch(packed: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
            cfm: ModelConfig, mrelu_head: bool, dropout_rate: float = 0.0,
            seed: int = 0, mol_base: int = 0, cluster: Optional[int] = None,
            l2_rows: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch itself, on inputs ``_check_shapes`` accepted; past 128
    columns at ``cluster`` blocks a molecule (None: ``forward_cluster``);
    past 256 on the rows ``l2_rows`` of ``l2_rows_shape`` (allocated here
    when None; their contents mean nothing between launches)."""
    B, M = inputs["atomic"].shape[:2]
    N = inputs["neighbors"].shape[2]
    seg, S = segment_arguments(inputs)
    check_supported(cfm, M, N, S)
    bf16 = operand_mode(cfm)
    chunk_atoms, work, _ = shared_memory_plan(cfm, M, N, S)
    tensors, dims, scalars, rng, pred, ga = launch_arguments(
        packed, inputs, cfm, mrelu_head, dropout_rate, seed, mol_base, chunk_atoms, work)
    lib = library(cfm)
    # past 128 columns, pointer 50: the packed TF32 planes of the layers'
    # products, and size 22: the blocks a molecule; past 256, pointer 51: the
    # query and scratch rows
    planes, blocks = [], []
    rows_shape = l2_rows_shape(cfm, B, M)
    if rows_shape is not None:
        if l2_rows is None:
            l2_rows = torch.empty(rows_shape, device=packed["wde"].device, dtype=torch.float32)
        elif tuple(l2_rows.shape) != rows_shape or not l2_rows.is_contiguous():
            raise ValueError(f"l2_rows of shape {tuple(l2_rows.shape)} handed to a launch "
                             f"that takes {rows_shape}")
    elif l2_rows is not None:
        raise ValueError("l2_rows: only #1 past 256 columns keeps rows in global memory")
    if width_class(cfm) > NARROW_WIDTH:
        if cluster is None:
            cluster = forward_cluster(cfm, B, M, N, S)
        if cluster not in FORWARD_CLUSTER_SIZES or cluster > chunk_count(cfm, M, N, S):
            raise ValueError(f"cluster={cluster}: #1 past 128 columns launches with one of "
                             f"{FORWARD_CLUSTER_SIZES} blocks a molecule, at most one a chunk "
                             f"of atoms ({chunk_count(cfm, M, N, S)} here)")
        planes, blocks = [packed["tf32_planes"]] + ([l2_rows] if rows_shape else []), [cluster]
    elif cluster not in (None, 1):
        raise ValueError(f"cluster={cluster}: #1 up to 128 columns launches one block a molecule")
    call_kernel(lib, lib, packed["wde"].device, tensors + [seg] + planes,
                dims + [S, bf16] + blocks, scalars, rng)
    fused_scann_forward.launches += 1
    fused_scann_forward.bf16_launches += bf16
    fused_scann_forward.d256_launches += width_class(cfm) == 256
    fused_scann_forward.d512_launches += width_class(cfm) == 512
    return pred.view(B, max(S, 1)), ga.view(B, M, 1)


def operand_mode(cfm: ModelConfig) -> int:
    """1 for the bf16 operand mode (``model.dtype: bfloat16``), 0 for f32:
    the flag the whole-model forwards launch with."""
    return int(cfm.dtype == "bfloat16")


def fused_scann_forward(params: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                        cfm: ModelConfig, mrelu_head: bool = False,
                        dropout_rate: float = 0.0, seed: int = 0, mol_base: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-model forward -> (property [B, 1], ga_score [B, M, 1]), f32;
    the training forward at ``dropout_rate`` > 0 (masks keyed on ``seed``
    and on each molecule's global row, ``mol_base`` + its row here).
    A packed batch (``segment_onehot`` [B, M, S]) gives the property [B, S].

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise (unsupported shape, bad input, an index out of range, failed build
    or launch)."""
    dev = inputs["atomic"].device
    if dev.type == "cpu":
        return reference_scann_forward(params, inputs, cfm, mrelu_head, dropout_rate, seed,
                                       mol_base)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_index_ranges(inputs, cfm)
    return launch_scann_forward(pack_params(params, cfm), inputs, cfm, mrelu_head,
                                dropout_rate, seed, mol_base)


fused_scann_forward.launches = 0
fused_scann_forward.bf16_launches = 0
fused_scann_forward.d256_launches = 0
fused_scann_forward.d512_launches = 0


def attention_scale(cfm: ModelConfig) -> float:
    """The query scale hd ** -scale, in float32 as the eager model has it."""
    hd = cfm.local_dim // cfm.num_head
    return float(np.float32(hd) ** np.float32(-cfm.scale))


def forward_flops(cfm: ModelConfig, B: int, M: int, N: int) -> int:
    """Multiply-add FLOPs (2 per product term) of the forward at one padded
    batch, counted from the kernel's products; the neighbour gather, the RBF
    exponentials and the other elementwise work are left out. The kernel's
    bound takes ``forward_fp32_flops`` of them at the FP32 rate and the rest
    at a third of the dense TF32 rate: the split-TF32 products keep f32
    accuracy with three tensor-core passes."""
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


def forward_fp32_flops(cfm: ModelConfig, B: int, M: int, N: int) -> int:
    """Of ``forward_flops``, the FLOPs that run on the CUDA cores in f32:
    each layer's energies and context (one warp per atom and head), the
    readout's elementwise terms and its one-row head. The rest are the
    split-TF32 products, three TF32 passes each on the tensor cores."""
    D, G, O = cfm.local_dim, cfm.global_dim, cfm.dense_out
    return B * (cfm.n_attention * 2 * M * N * D * 2 + 6 * M * G + 2 * G * O + 2 * O)
