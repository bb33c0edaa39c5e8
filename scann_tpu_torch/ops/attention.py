"""Plain PyTorch attention cores (port of ``scann_tpu/ops/attention.py``).

- ``local_attention_core``: per-center softmax attention over Voronoi
  neighbors, multi-head, with the query-side ``hd**-scale`` scaling, the
  additive -1e9 neighbor mask and the masked context sum.
- ``global_attention_core``: per-atom GA score = softmax over atoms of the
  diagonal-excluded row sum of the pairwise K.Q energy, computed through

      agg_i = (m_i K_i) . (sum_j m_j Q_j) - m_i^2 (K_i . Q_i)

  in O(B M D) instead of materializing the [B, M, M] energy. With
  ``segment_onehot`` (structure packing, ``data/packing.py``) every
  per-structure reduction runs per segment of the slot.
- ``segment_ids``: the per-row segment id [B, M] (-1 on padded rows) that
  the whole-model kernels take in place of the one-hot.

Tensors of the bfloat16 model (``model.dtype: bfloat16``) may mix bfloat16
and float32, as the flax modules' tensors do; ``promoted`` casts the
operands of a product to their common type, as jnp promotes them.
"""

import functools
from typing import List, Optional, Tuple

import torch


def promoted(*ts: torch.Tensor) -> List[torch.Tensor]:
    """``ts`` in their promoted dtype (bfloat16 with float32: float32, as jnp
    promotes); a tensor already of that dtype is returned as it is."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return [t.to(dt) for t in ts]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the operands' promoted dtype."""
    a, b = promoted(a, b)
    return a @ b


def gather_neighbor_states(states: torch.Tensor,
                           neighbor_idx: torch.Tensor) -> torch.Tensor:
    """states [B, M, D], neighbor_idx [B, M, N] (indices into M, padding
    remapped to 0) -> [B, M, N, D], by plain index gather."""
    B = states.shape[0]
    rows = torch.arange(B, device=states.device)[:, None, None]
    return states[rows, neighbor_idx.long()]


def local_attention_core(
    query: torch.Tensor,   # [B, M, D]    (projected centers)
    key: torch.Tensor,     # [B, M, N, D] (projected neighbor * geometry)
    value: torch.Tensor,   # [B, M, N, D]
    mask: torch.Tensor,    # [B, M, N]    float valid-neighbor mask
    num_head: int,
    scale: float = 0.5,
    dropout_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked multi-head attention over the neighbor axis.

    Returns (attn [B, H, M, N], context [B, M, D]); the context is the
    masked neighbor sum of attn-weighted values, before the +query residual
    and the LayerNorm. ``dropout_mask`` [B, H, M, N] (0 or 1/keep, the
    training ``use_drop`` attention dropout) scales the probabilities the
    context uses; the returned attn is the one before dropout, as in
    ``scann_tpu/ops/attention.py:92-100``.
    """
    B, M, D = query.shape
    N = key.shape[2]
    H = num_head
    hd = D // H
    q = query.reshape(B, M, H, hd)
    k = key.reshape(B, M, N, H, hd)
    v = value.reshape(B, M, N, H, hd)

    dk = torch.tensor(hd, dtype=q.dtype) ** torch.tensor(-scale, dtype=q.dtype)
    q = q * dk.to(q.device)

    energy = torch.einsum("bmhd,bmnhd->bhmn", *promoted(q, k))
    energy = energy + (1.0 - mask[:, None, :, :]) * -1e9
    attn = torch.softmax(energy, dim=-1)
    # the dropped-out probabilities keep their dtype, as flax's dropout keeps it
    attn_used = attn if dropout_mask is None else (attn * dropout_mask).to(attn.dtype)

    context = torch.einsum("bhmn,bmn,bmnhd->bmhd", *promoted(attn_used, mask, v))
    return attn, context.reshape(B, M, D)


def global_attention_core(
    query: torch.Tensor,   # [B, M, G] (projected)
    key: torch.Tensor,     # [B, M, G] (projected)
    value: torch.Tensor,   # [B, M, G]
    mask: torch.Tensor,    # [B, M, 1] float atom mask
    norm: bool = True,
    segment_onehot: Optional[torch.Tensor] = None,   # [B, M, S]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GA-score readout. Returns (attn [B, M, 1], context [B, G]), or with
    ``segment_onehot`` (several structures per slot) (attn [B, M, 1],
    context [B, S, G]): one pooled representation per segment."""
    mk = mask * key
    mq = mask * query
    if segment_onehot is not None:
        return _segmented_global_attention(mk, mq, value, mask,
                                           segment_onehot.to(mk.dtype), norm)
    q_sum = mq.sum(dim=1, keepdim=True)                  # [B, 1, G]
    cross = (mk * q_sum).sum(dim=-1, keepdim=True)      # [B, M, 1]
    diag = (mk * mq).sum(dim=-1, keepdim=True)          # [B, M, 1]
    agg = mask * (cross - diag)

    if norm:
        # euclidean normalization over atoms. A single-atom structure has
        # an exactly-zero sum (the diagonal exclusion removes its only
        # term); the guard wraps the SUM before the sqrt, so neither the
        # value nor its gradient turns NaN.
        sq = (agg * agg).sum(dim=1, keepdim=True)
        nrm = torch.sqrt(torch.where(sq == 0, torch.ones_like(sq), sq))
        agg = agg / nrm

    agg = agg + (1.0 - mask) * -1e9
    attn = torch.softmax(agg, dim=1)
    context = (mask * attn * value).sum(dim=1)          # [B, G]
    return attn, context


def _segmented_global_attention(mk, mq, value, mask, seg, norm):
    """Per-segment GA reductions for packed slots, as
    ``scann_tpu/ops/attention.py:166-200``: ``seg`` [B, M, S] has one hot
    per valid atom and zero rows on padding. The softmax is shifted by the
    slot's max, which is constant within every segment; a segment whose
    sum underflows to 0 gets attention 0, as does every padded row."""
    qseg = torch.einsum("bms,bmg->bsg", seg, mq)
    q_own = torch.einsum("bms,bsg->bmg", seg, qseg)
    cross = (mk * q_own).sum(dim=-1, keepdim=True)
    diag = (mk * mq).sum(dim=-1, keepdim=True)
    agg = mask * (cross - diag)

    if norm:
        # per-segment euclidean norm, the guard around the sum as unpacked
        sq = torch.einsum("bms,bm->bs", seg, agg[..., 0] * agg[..., 0])
        nrm = torch.sqrt(torch.where(sq == 0, torch.ones_like(sq), sq))
        nrm_own = torch.einsum("bms,bs->bm", seg, nrm)[..., None]
        agg = agg / torch.where(nrm_own == 0, torch.ones_like(nrm_own), nrm_own)

    agg = agg + (1.0 - mask) * -1e9
    attn = _SegmentSoftmax.apply(agg - agg.amax(dim=1, keepdim=True).detach(), mask, seg)
    context = torch.einsum("bms,bmg->bsg", seg, attn * value)
    return attn, context


class _SegmentSoftmax(torch.autograd.Function):
    """attn = exp(z) mask / (its segment's sum, 1 where that is 0), with
    the softmax's own backward, dz = attn (g - the segment's sum of attn g),
    as the TPU kernels differentiate it (``scann_backward.py:367-374``):
    autograd through the division would square a sum that underflowed to a
    denormal and turn the gradient into NaN."""

    @staticmethod
    def forward(ctx, z, mask, seg):
        e = torch.exp(z) * mask
        den = torch.einsum("bms,bm->bs", seg, e[..., 0])
        den_own = torch.einsum("bms,bs->bm", seg, den)[..., None]
        attn = e / torch.where(den_own == 0, torch.ones_like(den_own), den_own)
        ctx.save_for_backward(attn, seg)
        return attn

    @staticmethod
    def backward(ctx, g):
        attn, seg = ctx.saved_tensors
        gd = torch.einsum("bms,bm->bs", seg, (attn * g)[..., 0])
        return attn * (g - torch.einsum("bms,bs->bm", seg, gd)[..., None]), None, None


def segment_ids(segment_onehot: torch.Tensor) -> torch.Tensor:
    """[B, M, S] one-hot -> int32 [B, M]: each row's segment, -1 on a row
    that belongs to none (padding). Computed where the one-hot lies, with
    nothing read back."""
    ids = segment_onehot.argmax(dim=-1).to(torch.int32)
    return torch.where(segment_onehot.sum(dim=-1) > 0, ids, torch.full_like(ids, -1))
