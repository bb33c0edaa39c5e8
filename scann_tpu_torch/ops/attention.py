"""Plain PyTorch attention cores (port of ``scann_tpu/ops/attention.py``).

- ``local_attention_core``: per-center softmax attention over Voronoi
  neighbors, multi-head, with the query-side ``hd**-scale`` scaling, the
  additive -1e9 neighbor mask and the masked context sum.
- ``global_attention_core``: per-atom GA score = softmax over atoms of the
  diagonal-excluded row sum of the pairwise K.Q energy, computed through

      agg_i = (m_i K_i) . (sum_j m_j Q_j) - m_i^2 (K_i . Q_i)

  in O(B M D) instead of materializing the [B, M, M] energy.

Packed segments (several structures per padded slot) are not ported yet.
"""

from typing import Tuple

import torch


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked multi-head attention over the neighbor axis.

    Returns (attn [B, H, M, N], context [B, M, D]); the context is the
    masked neighbor sum of attn-weighted values, before the +query residual
    and the LayerNorm.
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

    energy = torch.einsum("bmhd,bmnhd->bhmn", q, k)
    energy = energy + (1.0 - mask[:, None, :, :]) * -1e9
    attn = torch.softmax(energy, dim=-1)

    context = torch.einsum("bhmn,bmn,bmnhd->bmhd", attn, mask, v)
    return attn, context.reshape(B, M, D)


def global_attention_core(
    query: torch.Tensor,   # [B, M, G] (projected)
    key: torch.Tensor,     # [B, M, G] (projected)
    value: torch.Tensor,   # [B, M, G]
    mask: torch.Tensor,    # [B, M, 1] float atom mask
    norm: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GA-score readout. Returns (attn [B, M, 1], context [B, G])."""
    mk = mask * key
    mq = mask * query
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
