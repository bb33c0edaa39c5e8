"""Analytic FLOP, operation and byte model of the SCANN forward and
training step (port of ``scann_tpu/utils/flops.py``), and the H100's
published rates.

The counts are those of the JAX package, function for function, for the
same ``ModelConfig`` fields: every dense product or einsum of the model at
a padded shape (M atoms, N neighbours) counts ``2*m*n*k``, elementwise,
softmax and LayerNorm terms small constants (reference
``scann_model.py:329-453``, ``attention.py:118-216,267-318``).

Conventions:
- forward FLOPs are per structure;
- training is 3x the forward: the backward of a product chain costs two
  products per product, and Adam is noise at these sizes;
- the neighbour gather is not a useful FLOP. The JAX package gathers on
  the TPU by a one-hot product on the matrix unit, which
  ``gather_flops_per_structure`` counts; the port gathers by index (an
  address per neighbour, no product), so it keeps that function only for
  parity, and ``utils/roofline.step_ceiling`` does not charge it to the
  tensor cores. MFU = useful model FLOPs / peak.

Peaks. The port runs its float32 products as split TF32 on the tensor
cores (``csrc/scann_mma.cuh``: three ``mma.sync`` passes, hi*hi + hi*lo +
lo*hi, per useful product), so the peak an MFU is read against is the
dense TF32 rate: one useful product FLOP costs three TF32 FLOPs, so a share
against 495 TFLOP/s stays under 1/3 for the products and under 100% in
all (the rest runs on the CUDA cores, at most 67/495 of it). Against the
67 TFLOP/s of FP32 outside the tensor cores a share could read over 100%,
a reading that no card gives.
"""

from typing import Optional

from scann_tpu_torch.config import ModelConfig

RBF_CENTERS = 20  # linspace(0, gaussian_d, 20), scann_model.py:378


def forward_flops_per_structure(cfm: ModelConfig, M: int, N: int) -> float:
    """Useful forward FLOPs for ONE structure at padded shape (M, N)."""
    d = cfm.local_dim
    g = cfm.global_dim
    h = cfm.num_head
    E = cfm.embedding_dim
    K = RBF_CENTERS
    L = cfm.n_attention

    f = 0.0
    # embedding: table lookup (atomic) or dense (cgcnn), then dense_embed
    if cfm.feature == "cgcnn":
        f += 2 * M * 92 * E
    e_in = E + (10 if cfm.use_ring else 0)
    if cfm.use_ring:
        f += 2 * M * 2 * 10  # extra_embed Dense(2->10)
    f += 2 * M * e_in * d  # dense_embed

    # distance RBF (exp per center) and SCANN+ geometry embeddings
    f += 5 * M * N * K
    if cfm.g_update:
        f += 5 * M * N * K          # solid-angle RBF
        f += 2 * M * N * K * d * 2  # neighbor_d + neighbor_w denses
        f += M * N * d              # geometry = d_emb * w_emb

    # per LocalAttention layer (attention.py:118-216)
    per_layer = 0.0
    if cfm.g_update:
        # filter_geo(concat[center, geo, neighbor]) in split-product form:
        # the center term is one [M,d]x[d,d] product broadcast over
        # neighbours; geo+neighbor terms are [M,N,d]x[d,d]; then residual
        # add + LayerNorm on [M, N, d]
        per_layer += 2 * M * d * d + 2 * 2 * M * N * d * d
        per_layer += 10 * M * N * d
    else:
        # filter_geo on the distance RBF: Dense(K -> d), times voronoi weight
        per_layer += 2 * M * N * K * d + M * N * d
    per_layer += M * N * d          # neighbor * geometry
    per_layer += 2 * M * N * d * d  # K projection [M,N,d]->[M,N,d]
    per_layer += 2 * M * d * d      # Q projection
    per_layer += 2 * M * N * d      # QK energy einsum (per-head dot)
    per_layer += 6 * M * N * h      # masked softmax over N
    per_layer += 2 * M * N * d      # context = attn . V
    per_layer += 10 * M * d         # residual + LayerNorm
    if cfm.use_attn_norm:
        per_layer += 2 * 2 * M * d * d  # ResidualNorm: two Dense(d->d)
        per_layer += 10 * M * d
    f += L * per_layer

    # readout
    f += 2 * M * d * g              # after_Lc
    f += 2 * 2 * M * g * g          # GA query/key projections
    f += 4 * M * g                  # O(M.D) GA identity (ops/attention.py)
    f += 6 * M                      # GA softmax over atoms
    f += 2 * M * g                  # pooled context
    f += 2 * g * cfm.dense_out      # bf_property
    f += 2 * cfm.dense_out          # predict_property
    return f


def train_flops_per_structure(cfm: ModelConfig, M: int, N: int) -> float:
    """Forward + backward (~2x forward for a product chain)."""
    return 3.0 * forward_flops_per_structure(cfm, M, N)


def gather_flops_per_structure(cfm: ModelConfig, M: int, N: int,
                               training: bool = True) -> float:
    """FLOPs of the JAX package's one-hot neighbour gather on the TPU's
    matrix unit: [M*N, M] @ [M, d] per layer, plus the transposed scatter
    in the backward. Not a useful FLOP, and not work the port does: its
    kernels and ``ops.attention`` gather by index. Kept for parity with the
    JAX package's counts."""
    d = cfm.local_dim
    L = cfm.n_attention
    per_layer = 2 * M * N * M * d          # one-hot gather product
    if training:
        per_layer *= 3                     # bwd: scatter (A^T) + regather
    return L * per_layer


def vpu_costs_per_structure(cfm: ModelConfig, M: int, N: int,
                            training: bool = True) -> dict:
    """Operation counts outside the products for ONE structure at padded
    shape (M, N) (the JAX name: on the TPU they run on its vector unit; on
    the card, on the CUDA cores):

    - ``transcendentals``: exp evaluations (swish sigmoids, RBF gaussians,
      softmax) plus LayerNorm rsqrts, dominated by the [M,N,D]-stream swish
      of the SCANN+ geometry update: (L+2)*M*N*D exps forward. On the card
      each ``expf`` issues one instruction on the special-function units.
    - ``elementwise``: simple ops (add/mul/select) on the activation
      streams, counted with small per-tensor constants (±30% fidelity: the
      point is the order of this term against the products').

    ``training=True`` counts the keep-activations backward: each
    transcendental is evaluated about once more from its stashed
    pre-activation (~2x forward), elementwise follows the ~3x rule of a
    product chain. The algorithmic minimum (every sigmoid value stashed
    too) is ~1x transcendentals: ``roofline.step_ceiling(schedule=
    "stash_all")``.
    """
    d = cfm.local_dim
    g = cfm.global_dim
    h = cfm.num_head
    K = RBF_CENTERS
    L = cfm.n_attention

    trans = M * d                 # dense_embed swish
    trans += M * N * K            # distance RBF exp
    elem = 4 * M * N * K          # RBF (d - c)^2 / width etc.
    if cfm.g_update:
        trans += M * N * K        # solid-angle RBF exp
        trans += 2 * M * N * d    # d_emb + w_emb swish
        elem += 4 * M * N * K + 4 * M * N * d
    per_layer_trans = 0.0
    per_layer_elem = 0.0
    if cfm.g_update:
        per_layer_trans += M * N * d   # u_pre swish ([M,N,D] stream)
        per_layer_trans += M * N       # geometry LayerNorm rsqrt
        per_layer_elem += 10 * M * N * d  # u_pre adds, residual, LN norm
    else:
        per_layer_trans += M * N * d   # filter_geo swish
        per_layer_elem += 2 * M * N * d
    per_layer_trans += M * N * h       # softmax exp over neighbors
    per_layer_elem += 6 * M * N * h    # softmax max/sub/sum/div + mask
    per_layer_elem += 4 * M * N * d    # ns*geo, QK prod, attn*key, mask
    per_layer_trans += M * d           # h1 swish
    per_layer_trans += 2 * M           # o1 + context LayerNorm rsqrt
    per_layer_elem += 12 * M * d       # residuals + two LN normalizations
    trans += L * per_layer_trans
    elem += L * per_layer_elem

    trans += M * g + M + cfm.dense_out  # after_Lc swish, GA softmax, bf swish
    elem += 8 * M * g

    if training:
        # keep-acts backward: each transcendental re-evaluated ~once from
        # the stashed pre-activation; elementwise ~2x more in the bwd chain
        trans *= 2.0
        elem *= 3.0
    return {"transcendentals": trans, "elementwise": elem}


def hbm_bytes_per_structure(cfm: ModelConfig, M: int, N: int,
                            batch_size: int, training: bool = True) -> float:
    """HBM traffic per structure per step: the input streams of the batch
    (the bucket is device-resident; each step reads its batch rows) plus the
    parameter read (+ gradient write + Adam state) amortized over the
    batch. The fused kernels keep activations on chip, so no activation
    spill is counted."""
    input_bytes = (4 * M * N * 4        # neighbors/mask/weight/distance f32
                   + M * (4 + 4))       # atomic + atom_mask
    p = _param_count(cfm)
    # params read (fwd+bwd) + grad write + Adam mu/nu read+write, all f32
    param_traffic = (2 + 1 + 4) * 4 * p if training else 4 * p
    return input_bytes + param_traffic / batch_size


def _param_count(cfm: ModelConfig) -> float:
    """Parameters of the model: exact for the atomic-number embedding
    without ring features; like the JAX function it leaves out the ring
    embedding (``extra_embed``, 2*10 + 10, and the 10 extra input rows of
    ``dense_embed``) and counts a cgcnn model's embedding as a table."""
    d, g = cfm.local_dim, cfm.global_dim
    E, K, L = cfm.embedding_dim, RBF_CENTERS, cfm.n_attention
    p = cfm.n_atoms * E + E * d + d            # embed + dense_embed
    if cfm.g_update:
        p += 2 * (K * d + d)                   # neighbor_d / neighbor_w
        p += L * (3 * d * d + d + 2 * d)       # filter_geo + geometry LN
    else:
        p += L * (K * d + d)
    p += L * (2 * d * d + 2 * d + 2 * d)       # Q/K proj + output LN
    if cfm.use_attn_norm:
        p += L * (2 * d * d + 2 * d + 2 * d)   # ResidualNorm
    p += d * g + g + 2 * g * g + 2 * g         # after_Lc + GA projections
    p += g * cfm.dense_out + cfm.dense_out + cfm.dense_out + 1
    return p


# Published dense rates of NVIDIA's cards (data sheets, SXM parts, without
# sparsity), at the full power limit (700 W for the H100 SXM): TF32 on the
# tensor cores, FP32 outside them, and HBM bandwidth. "H100 80GB HBM3" is
# the name torch.cuda.get_device_name gives the SXM part ("H100 PCIe" and
# "H100 NVL" are other parts with other rates and are not listed).
_PEAKS = {
    "h100 80gb hbm3": {"tf32_tflops": 495.0, "fp32_tflops": 67.0, "hbm_bytes_s": 3.35e12},
}
# Results a streaming multiprocessor gives each clock (CUDA C++ Programming
# Guide, "Arithmetic Instructions", compute capability 9.0): 128 FP32 FMAs
# (two FLOPs each) and 16 from the special-function units (exp2, rsqrt,
# sin, ...). Each ``expf`` issues one of the latter.
_FMA_PER_SM_CLOCK = 128
_SFU_PER_SM_CLOCK = 16


def _peaks(device_name: Optional[str]) -> Optional[dict]:
    if device_name is None:
        import torch

        device_name = torch.cuda.get_device_name(0)
    name = device_name.lower()
    for key, val in _PEAKS.items():
        if key in name:
            return val
    return None


def peak_tflops(device_name: Optional[str] = None) -> Optional[float]:
    """Dense TF32 tensor-core TFLOP/s of the card named ``device_name``
    (``torch.cuda.get_device_name``; the current card when None), the
    denominator of the port's MFU; None for a card not in the table."""
    p = _peaks(device_name)
    return p["tf32_tflops"] if p else None


def peak_fp32_tflops(device_name: Optional[str] = None) -> Optional[float]:
    """FP32 TFLOP/s outside the tensor cores (an FMA is two FLOPs)."""
    p = _peaks(device_name)
    return p["fp32_tflops"] if p else None


def peak_hbm_bytes_s(device_name: Optional[str] = None) -> Optional[float]:
    """HBM bytes per second."""
    p = _peaks(device_name)
    return p["hbm_bytes_s"] if p else None


def peak_exp_per_s(device_name: Optional[str] = None) -> Optional[float]:
    """Special-function results per second at the clock of the published
    FP32 rate (16 a clock an SM against 128 FMAs): no ``expf`` chain runs
    faster."""
    p = _peaks(device_name)
    if p is None:
        return None
    return p["fp32_tflops"] * 1e12 / (2 * _FMA_PER_SM_CLOCK) * _SFU_PER_SM_CLOCK
