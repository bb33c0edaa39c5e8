"""The forward builds redesigned at 256 columns, #1
(``csrc/scann_forward_d256.cu``), the tall #3
(``csrc/scann_loop_tall_d256.cu``) and the narrow #5
(``csrc/local_attention_d256.cu``), on the CPU: what their launches are
handed and planned, and their plain versions against the JAX package.

- The packed TF32 planes of the products' weights (``kfwd.tf32_planes``):
  hi + lo == w in f32, hi with its 13 low bits clear and equal to the split
  the kernels made at every use (``split_tf32`` of ``csrc/scann_mma.cuh``),
  lo 0 for a bfloat16 weight, the bf16 plane w rounded; element by element
  in the order ``mma_gemm_w32`` reads them; ``pack_params`` holds a layer's
  (``layer_tf32_planes``) past 128 columns only, and ``kla.layer_planes``
  keeps them on the weight until it changes.
- The plans: #5's narrow plan past 128 columns (``kla.d256_block_plan``,
  ``make_plan``) term by term at the published widths, within 232,448 B,
  two operand buffers of 32 rows at MP2018 (AB = 16), and the CUDA
  source's terms; #3's tall plan at the MP2018 recipe bucket.
- The launches (a stub in place of the CUDA library): the planes handed to
  #1 and to the tall and wide #3 (both operand modes, #1 packed too) and
  to the narrow and wide #5 past 128 columns, and to no build up to 128
  columns.
- The plain versions of #3 and #5 at D = 256 against the JAX kernels in
  interpret mode at N = 16 and 32, and #1's on a packed batch, rtol 1e-5 /
  atol 1e-6, as ``tests/test_torch_widths.py`` (#5's updated geometry at
  atol 2e-6: f32 noise of a LayerNorm over 256 columns, ``GEO_ATOL``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_synthetic_batch
from scann_tpu.kernels import local_attention as jla
from scann_tpu.kernels.scann_loop import loop_scann_forward as jax_loop_forward
from scann_tpu.kernels.scann_forward import fused_scann_forward as jax_fused_forward
from scann_tpu_torch.data import packing
from scann_tpu_torch.kernels import _build
from scann_tpu_torch.kernels import local_attention as kla
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.kernels import widths
from scann_tpu_torch.models import init_params
from test_torch_packing import _models, _packed_batch
from test_torch_widths import MP2018, SMALL, WIDTHS, _flat_params, _layer_inputs, _setup, _torch

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
# The updated geometry at D = 256 is a LayerNorm over 256 columns of values of
# order 1, whose f32 rounding in XLA and in PyTorch differs by up to ~8 ulps
# there (1.05e-6 on one of 163,840 values at N = 32): its atol is 2e-6.
GEO_ATOL = 2e-6


def _split_at_use(w: np.ndarray):
    """split_tf32 of csrc/scann_mma.cuh in numpy: hi, and the bits of lo as
    the kernels hand them to the tensor cores (13 low bits ignored)."""
    bits = w.astype(np.float32).view(np.uint32)
    hi = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    lo = ((w - hi).astype(np.float32).view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return hi, lo


def _plane_floats(R, C):
    """w32_plane_floats of csrc/scann_mma.cuh."""
    return -(-C // 32) * 2 * -(-R // 32) * 12 * 32 * 4


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_torch_d256_tf32_planes_split_once(scale):
    rng = np.random.default_rng(int(scale * 7) + 1)
    w = (scale * rng.normal(size=(3, 40, 36))).astype(np.float32)
    packed = kfwd.tf32_planes(torch.from_numpy(w))
    assert packed.shape == (3, _plane_floats(40, 36)) and packed.dtype == torch.float32
    planes = kfwd.unpack_tf32_planes(packed, 40, 36).numpy()
    hi, lo, b16 = planes[:, 0], planes[:, 1], planes[:, 2]
    assert np.array_equal(hi + lo, w)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    want_hi, want_lo = _split_at_use(w)
    assert np.array_equal(hi.view(np.uint32), want_hi.view(np.uint32))
    got_lo = (lo.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    assert np.array_equal(got_lo, want_lo)
    assert torch.equal(torch.from_numpy(b16), torch.from_numpy(w).bfloat16().float())


def test_torch_d256_tf32_planes_of_bf16_weights():
    """A bfloat16 weight is exact in TF32: hi is the weight, lo is 0."""
    w = torch.randn(16, 8, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    planes = kfwd.unpack_tf32_planes(kfwd.tf32_planes(w), 16, 8)
    assert torch.equal(planes[0], w.float()) and not planes[1].any()
    assert torch.equal(planes[2], w.float())


def test_torch_d256_tf32_planes_in_the_order_the_lanes_read():
    """Element by element, the float ``mma_gemm_w32`` reads for column group
    G, half s, quad q = 4 plane + i, lane 4g + t and column j is plane
    ``plane``'s row 32 (s // 2) + 8t + 4 (s % 2) + i at column 32G + 4g + j,
    zero in the padding."""
    R, C = 70, 72
    w = torch.randn(R, C, generator=torch.Generator().manual_seed(4))
    flat = kfwd.tf32_planes(w)
    planes = kfwd.unpack_tf32_planes(flat, R, C)
    S = 2 * -(-R // 32)
    idx = torch.arange(flat.numel())
    j, lane = idx % 4, (idx // 4) % 32
    q, rest = (idx // 128) % 12, idx // (128 * 12)
    s, G = rest % S, rest // S
    g, t_, plane, i = lane // 4, lane % 4, q // 4, q % 4
    k = 32 * (s // 2) + 8 * t_ + 4 * (s % 2) + i
    n = 32 * G + 4 * g + j
    inside = (k < R) & (n < C)
    want = torch.zeros_like(flat)
    want[inside] = planes[plane[inside], k[inside], n[inside]]
    assert torch.equal(flat, want)


@pytest.mark.parametrize("D,planes", [(128, False), (256, True), (136, True)])
def test_torch_d256_pack_params_holds_the_planes(D, planes):
    cfm = dataclasses.replace(MP2018, n_attention=2, local_dim=D, global_dim=D, dense_out=D)
    packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0)), cfm)
    assert ("tf32_planes" in packed) == planes
    if planes:
        want = torch.cat([kfwd.layer_tf32_planes(packed["wfg"], packed["wk"], packed["wq"], True),
                          kfwd.tf32_planes(packed["wr1"]), kfwd.tf32_planes(packed["wr2"])], -1)
        n = _plane_floats(D, D) * 5 + _plane_floats(2 * D, D)    # row_planes' blocks, W1, W2
        assert packed["tf32_planes"].shape == (2, n)
        assert torch.equal(packed["tf32_planes"], want)
        wfg = packed["wfg"][1]
        first = kfwd.unpack_tf32_planes(packed["tf32_planes"][1, :_plane_floats(D, D)], D, D)
        assert torch.equal(first[0] + first[1], wfg[:D])


def test_torch_d256_layer_planes_are_kept_until_the_weight_changes():
    rng = np.random.default_rng(5)
    params = _flat_params(_layer_inputs(rng, 1, 4, 8, 256, True)[5])
    first = kla.layer_planes(params, True)
    assert kla.layer_planes(params, True) is first
    params["key/kernel"].mul_(2.0)
    again = kla.layer_planes(params, True)
    assert again is not first
    assert torch.equal(again, kfwd.layer_tf32_planes(params["filter_geo/kernel"],
                                                     params["key/kernel"],
                                                     params["query/kernel"], True))
    other = dict(params, **{"query/kernel": params["query/kernel"].clone()})
    assert kla.layer_planes(other, True) is not again
    scann = kla.layer_planes(dict(params, **{"filter_geo/kernel": params["key/kernel"][:20]}),
                             False)
    assert scann.shape == (_plane_floats(20, 256) + 2 * _plane_floats(256, 256),)


# --- plans ---------------------------------------------------------------------

def _d256_terms(AB, N, D, H, g_update, bf16):
    """d256_plan_for of csrc/local_attention.cu, term by term."""
    ca = min(AB, max(1, 32 // N))
    rows = ca * N
    front = max(rows * (D + 4) + -(-rows * H // 4) * 4, AB * (D + 4))
    slots = (2 if g_update else 1) * AB * (D + 4)
    two = slots + front + 2 * rows * (2 * D + 4) + (rows * D if bf16 else 0)
    if 4 * two <= kla.MAX_SHARED_BYTES:
        return ca, 2, 4 * two
    return ca, 1, 4 * (slots + front + rows * (2 * D + 4))


@pytest.mark.parametrize("N", [8, 12, 16, 24, 32, 48, 64])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("g_update", [True, False])
def test_torch_d256_layer_plan_fits_and_matches_its_terms(N, bf16, g_update):
    d256 = widths.class_of(256)
    for AB in d256.atom_blocks:
        plan = kla.d256_block_plan(AB, N, 256, 8, g_update, bf16)
        assert plan == _d256_terms(AB, N, 256, 8, g_update, bf16)
        assert plan[0] * N <= max(d256.chunk_rows, N)
    for B, M in ((1, 48), (8, 96), (8, 256), (64, 96)):
        ab, ca, nbytes = kla.make_plan(B, M, N, 256, 8, g_update, 132, bf16)
        assert ab in d256.atom_blocks and nbytes <= kla.MAX_SHARED_BYTES
        assert (ca, nbytes) == kla.d256_block_plan(ab, N, 256, 8, g_update, bf16)[::2]


def test_torch_d256_layer_plan_at_mp2018():
    """One MP2018 layer at D = 256 (64, 96, 32): atom blocks of 16 (not 8),
    chunks of one atom, two operand buffers; 48 atoms cost the same waves
    with one buffer and lose the tie."""
    assert kla.make_plan(64, 96, 32, 256, 8, True, 132) == (16, 1, 199680)
    assert kla.make_plan(64, 96, 32, 256, 8, True, 132, True) == (16, 1, 232448)
    assert kla.d256_block_plan(48, 32, 256, 8, True)[1] == 1
    assert kla.make_plan(8, 256, 32, 256, 8, True, 132) == (16, 1, 199680)
    assert kla.make_plan(64, 96, 64, 256, 8, True, 132)[0] == 8     # one buffer of 64 rows
    assert kla.make_plan(64, 96, 32, 128, 8, True, 132) == (    # up to 128: as it was
        48, *kla.block_plan(48, 32, 128, 8, True))


def test_torch_d256_plans_match_cuda_sources():
    with open(f"{_build.SRC_DIR}/local_attention.cu") as f:
        la = f.read()
    assert "constexpr int kD256ChunkRows = 32;" in la and widths.class_of(256).chunk_rows == 32
    assert "const int fit = kD256ChunkRows / N;" in la
    assert "p.work = p.offR + (bf16 ? rows * D : 0);" in la
    assert "(cost == best_cost && p.buffers > best.buffers)" in la
    with open(f"{_build.SRC_DIR}/scann_loop.cu") as f:
        loop = f.read()
    assert ("#if defined(SCANN_WIDTH_256) && (defined(SCANN_LOOP_TALL) || "
            "defined(SCANN_LOOP_WIDE))\nconstexpr bool kW32 = true;" in loop)
    assert "#ifdef SCANN_LOOP_TAKES_PLANES\n  const float* planes = (const float*)ptrs[52];" in loop
    with open(f"{_build.SRC_DIR}/scann_forward.cu") as f:
        fwd = f.read()
    # #1: the planes in the d256 build only, at pointer 50, a layer's at the
    # tall #3's offsets (row_planes' blocks, then W1 and W2)
    assert ("#ifdef SCANN_WIDTH_256\nconstexpr bool kW32 = true;\n"
            "#define SCANN_FORWARD_TAKES_PLANES\n") in fwd
    assert "#ifdef SCANN_FORWARD_TAKES_PLANES\n  const float* planes = (const float*)ptrs[50];" in fwd
    assert "#define SCANN_FORWARD_D256_PARAMS , const float* planes, const int C\n" in fwd
    assert "scann_forward_kernel(const Args a SCANN_FORWARD_D256_PARAMS)" in fwd
    # #1's clusters: size 22, up to kMaxForwardCluster blocks, one a chunk at least
    assert "constexpr int kMaxForwardCluster = 16;" in fwd
    assert kfwd.FORWARD_CLUSTER_SIZES == tuple(range(16, 0, -1))
    assert "  const int C = dims[22];\n" in fwd
    assert "if (C > (a.M + a.chunk_atoms - 1) / a.chunk_atoms) return kErrShape;" in fwd
    assert "const int m_lo = kCluster ? rank * chunks / C * CA : 0;" in fwd
    assert "const int m_hi = kCluster ? min(M, (rank + 1) * chunks / C * CA) : M;" in fwd
    # a cluster only at C > 1 (kCluster); the build up to 128 columns keeps
    # its one template argument
    assert "#define SCANN_FORWARD_CLUSTER_TPARAM , bool kCluster\n" in fwd
    assert "const auto kernel = C > 1 ? (bf16 ? scann_forward_kernel<true, true>" in fwd
    assert "const auto kernel = bf16 ? scann_forward_kernel<true> : scann_forward_kernel<false>;" in fwd
    assert "a.S = dims[20];\n  if ((dims[21] & ~1) ||" in fwd   # max_clusters reads launch_dims
    offset = "(layer_plane_floats(D, a.K, a.g_update) + 2 * w32_plane_floats(D, D)) * l;"
    assert offset in fwd and offset in loop
    assert "fwd_residual_norm<kBf16, true>(" in fwd and "fwd_chunk_w32<kBf16, float>(" in fwd
    with open(f"{_build.SRC_DIR}/scann_forward_d256.cu") as f:
        assert "#define SCANN_WIDTH_256\n#include \"scann_forward.cu\"" in f.read()
    with open(f"{_build.SRC_DIR}/scann_mma.cuh") as f:
        mma = f.read()
    assert "constexpr int kW32Quads = 12;" in mma
    assert "return (size_t)((nc + 31) / 32) * 2 * ((R + 31) / 32) * kW32Block;" in mma


@pytest.mark.parametrize("M", [96, 322, 1000])
def test_torch_d256_tall_plan_at_mp2018(M):
    """The tall #3 past 128 columns at MP2018's N = 32: chunks of one atom,
    atom blocks of 16, within a block's shared memory."""
    cfm = dataclasses.replace(MP2018)
    chunk_atoms, block, work, nbytes, _ = kloop.l2_memory_plan(cfm, M, 32)
    assert (chunk_atoms, block) == (1, 16) and nbytes <= kloop.MAX_SHARED_BYTES
    assert kloop.forward_library(cfm, M, 32)[0] == "scann_loop_tall_d256"


# --- launches --------------------------------------------------------------------

@pytest.mark.parametrize("case", ["tall f32", "tall bf16", "tall 128", "wide f32", "wide bf16",
                                  "wide 128", "layer", "layer wide", "layer 128", "fused f32",
                                  "fused bf16", "fused 128", "fused packed"])
def test_torch_d256_launches_hand_the_planes(case, monkeypatch):
    seen = []
    monkeypatch.setattr(kfwd, "call_kernel", lambda *a, **k: seen.append(a))
    monkeypatch.setattr(kloop, "max_active_forward_clusters", lambda *a, **k: 132)
    monkeypatch.setattr(kla, "sm_count", lambda dev: 132)
    monkeypatch.setattr(kfwd, "max_active_clusters", lambda cfm, B, M, N, C, S=0: 132 // C)
    D = 128 if case.endswith("128") else 256
    cfm = dataclasses.replace(MP2018, n_attention=2, local_dim=D, global_dim=D, dense_out=D)
    if case.startswith("fused"):
        # #1: pointer 50 past 128 columns (after the segment ids, pointer 49)
        if case.endswith("bf16"):
            cfm = dataclasses.replace(cfm, dtype="bfloat16")
        x = _torch(make_synthetic_batch(np.random.default_rng(0), B=3, M=12, N=16, n_atoms=95))
        if case.endswith("packed"):
            x = _torch(packing.pack_padded_inputs({k: v.numpy() for k, v in x.items()},
                                                  capacity=24, max_segments=4).inputs)
        packed = kfwd.pack_params(init_params(dataclasses.replace(cfm, dtype="float32"),
                                              torch.Generator().manual_seed(0)), cfm)
        kfwd._launch(packed, x, cfm, False)
        assert seen[0][:2] == (kfwd.library(cfm),) * 2
        assert (seen[0][3][49] is None) == (not case.endswith("packed"))
        if case.endswith("128"):
            # no pointer 50, no size 22
            assert kfwd.library(cfm) == "scann_forward" and len(seen[0][3]) == 50
            assert len(seen[0][4]) == 22 and seen[0][4][21] == 0
        else:
            assert len(seen[0][3]) == 51 and seen[0][3][50] is packed["tf32_planes"]
            # sizes 21 and 22: the operand mode and the blocks a molecule
            M, N = x["neighbors"].shape[1:]
            S = x["segment_onehot"].shape[-1] if "segment_onehot" in x else 0
            assert seen[0][4][21:] == [int(case.endswith("bf16")),
                                       kfwd.forward_cluster(cfm, x["atomic"].shape[0], M, N, S)]
        for name in ("launches", "bf16_launches", "d256_launches"):
            setattr(kfwd.fused_scann_forward, name, 0)
    elif case.startswith(("tall", "wide")):
        if case.endswith("bf16"):
            cfm = dataclasses.replace(cfm, dtype="bfloat16")
        # the wide build past 128 columns takes N > 32; up to 128 N > 64
        N = 16 if case.startswith("tall") else 72
        x = _torch(make_synthetic_batch(np.random.default_rng(0), B=2, M=40, N=N, n_atoms=95))
        packed = kfwd.pack_params(init_params(dataclasses.replace(cfm, dtype="float32"),
                                              torch.Generator().manual_seed(0)), cfm)
        kloop._launch(packed, x, cfm, False, tall=case.startswith("tall"))
        assert seen[0][1] == kloop.forward_library(cfm, 40, N, tall=case.startswith("tall"))[1]
        if case.endswith("128"):
            assert len(seen[0][3]) == 52   # no pointer 52
        else:
            assert len(seen[0][3]) == 53 and seen[0][3][52] is packed["tf32_planes"]
        for name in ("launches", "bf16_launches", "wide_launches", "tall_launches",
                     "d256_launches"):
            setattr(kloop.launch_loop_forward, name, 0)
    else:
        N = 96 if case == "layer wide" else 32
        c, i, g, m, w, p = _layer_inputs(np.random.default_rng(1), 2, 10, N, D, True)
        params = _flat_params(p)
        kla._launch(*[torch.from_numpy(a) for a in (c, i, g, m, w)], params, 8, 0.5, True)
        if case != "layer 128":
            assert len(seen[0][3]) == 20
            assert torch.equal(seen[0][3][19], kfwd.layer_tf32_planes(
                params["filter_geo/kernel"], params["key/kernel"], params["query/kernel"], True))
        else:
            assert len(seen[0][3]) == 19   # no pointer 19
        for name in ("launches", "bf16_launches", "wide_launches", "d256_launches"):
            setattr(kla.fused_local_attention, name, 0)


# --- the plain versions against the JAX kernels ------------------------------------

@pytest.mark.parametrize("N", [16, 32])
@pytest.mark.parametrize("g_update", [True, False])
def test_torch_d256_layer_plain_matches_jax_kernel(N, g_update):
    """#5's plain version at D = 256 and the N the narrow build's chunks of
    32 rows hold (two atoms, one atom)."""
    rng = np.random.default_rng(N + 256)
    centers, idx, geometry, mask, weight, params = _layer_inputs(rng, 2, 10, N, 256, g_update)
    H, scale = 8, 0.5
    want = jla._pallas_forward(*[jnp.asarray(a) for a in (centers, idx, geometry, mask, weight)],
                               params, H, scale, g_update, interpret=True)
    with torch.no_grad():
        out, geo, attn = kla.fused_local_attention(
            *[torch.from_numpy(a) for a in (centers, idx, geometry, mask, weight)],
            _flat_params(params), H, scale, g_update)
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want[2]), rtol=RTOL, atol=ATOL)
    if g_update:
        np.testing.assert_allclose(geo.numpy(), np.asarray(want[1]), rtol=RTOL, atol=GEO_ATOL)


def test_torch_d256_tall_plain_matches_jax_kernel():
    """#3's plain version at D = G = O = 256 and N = 16, where the tall
    build past 128 columns takes the batch."""
    jcfg, tcfg, jp, tp, x = _setup("256", 37, M=12, N=16)
    assert kloop.forward_library(tcfg, 12, 16, tall=True)[0] == "scann_loop_tall_d256"
    want = jax_loop_forward(jp, x, jcfg, interpret=True)
    with torch.no_grad():
        got = kloop.loop_scann_forward(tp, _torch(x), tcfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_torch_d256_fused_plain_packed_matches_jax_kernel(width):
    """#1's plain version on a packed batch (the per-segment GA readout and
    head, an empty segment in every slot) past 128 columns, where the
    d256 build takes it, against the JAX kernel in interpret mode."""
    _, x, _ = _packed_batch(27)
    jcfg, tcfg, jvars, tparams = _models(27, x, small=SMALL, **WIDTHS[width])
    slots, M, S = x["segment_onehot"].shape
    assert kfwd.refusal(tcfg, M, x["neighbors"].shape[2], S) is None
    assert kfwd.library(tcfg) == "scann_forward_d256"
    jpred, jga = jax_fused_forward(jvars, {k: v for k, v in x.items() if k != "segment_mask"},
                                   jcfg, interpret=True, batch_tile=1)
    with torch.no_grad():
        pred, ga = kfwd.fused_scann_forward(tparams, _torch(x), tcfg)
    assert tuple(pred.shape) == tuple(jpred.shape) == (slots, S)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(jga), rtol=RTOL, atol=ATOL)


# --- #1's blocks a molecule past 128 columns ------------------------------------

@pytest.mark.parametrize("B,M,N,S,want", [
    (1, 32, 16, 0, 16),     # a lone QM9 molecule: one 2-atom chunk a block
    (16, 32, 16, 0, 6),     # 17 clusters of 6 run at once, 15 of 7
    (128, 32, 16, 0, 1),    # the batch fills the card
    (1, 30, 16, 0, 15),     # 15 chunks: no block without atoms
    (2, 8, 8, 0, 1),        # one chunk of 8 atoms
    (3, 48, 16, 8, 16),     # a packed slot of 48 rows, chunks of one atom
    (8, 48, 16, 8, 8),      # 7 clusters of 9-16 run at once, 15 of 8
])
def test_torch_d256_fused_cluster_rule(B, M, N, S, want, monkeypatch):
    """#1 past 128 columns takes the most blocks a molecule (up to 16) whose
    B clusters the card runs at once, at most one a chunk of atoms; up to
    128 columns one block a molecule, without asking the card."""
    occupancy = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
    asked = []

    def max_active(cfm, B, M, N, C, S=0):
        asked.append((B, C))
        return occupancy.get(C, 7)

    monkeypatch.setattr(kfwd, "max_active_clusters", max_active)
    cfm = dataclasses.replace(MP2018, local_dim=256, global_dim=256, dense_out=256)
    assert kfwd.forward_cluster(cfm, B, M, N, S) == want
    assert want <= kfwd.chunk_count(cfm, M, N, S) == -(-M // kfwd.shared_memory_plan(
        cfm, M, N, S)[0])
    assert kfwd.launch_dims(cfm, B, M, N, S)[16:18] == list(kfwd.shared_memory_plan(
        cfm, M, N, S)[:2])
    narrow = dataclasses.replace(cfm, local_dim=128, global_dim=128, dense_out=128)
    asked.clear()
    assert kfwd.forward_cluster(narrow, B, M, N, S) == 1 and not asked


def test_torch_d256_fused_launch_takes_a_cluster(monkeypatch):
    """The private ``_launch(..., cluster=)`` forces the blocks a molecule
    past 128 columns (chip_smoke's holds at every size); a size past the
    chunks or not in ``FORWARD_CLUSTER_SIZES`` is refused, and so is any
    size but 1 up to 128 columns."""
    seen = []
    monkeypatch.setattr(kfwd, "call_kernel", lambda *a, **k: seen.append(a))
    cfm = dataclasses.replace(MP2018, n_attention=1, local_dim=256, global_dim=256,
                              dense_out=256)
    x = _torch(make_synthetic_batch(np.random.default_rng(3), B=2, M=12, N=16, n_atoms=95))
    packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0)), cfm)
    chunks = kfwd.chunk_count(cfm, 12, 16)
    assert chunks == 6      # chunks of 2 atoms (32 rows) at D = 256
    for C in range(1, chunks + 1):
        kfwd._launch(packed, x, cfm, False, cluster=C)
        assert seen[-1][4][22] == C
    for C in (chunks + 1, 0, 17):
        with pytest.raises(ValueError, match="blocks a molecule"):
            kfwd._launch(packed, x, cfm, False, cluster=C)
    narrow = dataclasses.replace(cfm, local_dim=128, global_dim=128, dense_out=128)
    with pytest.raises(ValueError, match="one block a molecule"):
        kfwd._launch(kfwd.pack_params(init_params(narrow, torch.Generator().manual_seed(0)),
                                      narrow), x, narrow, False, cluster=2)
    for name in ("launches", "bf16_launches", "d256_launches"):
        setattr(kfwd.fused_scann_forward, name, 0)


def test_torch_d256_fused_max_clusters_asks_its_build(monkeypatch):
    """``kfwd.max_active_clusters`` asks the d256 build's own entry
    (``scann_forward_d256_max_clusters``) with the launch's sizes in the
    operand mode that launches, once a shape (``cluster_answer``)."""
    asked = []

    class Lib:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, symbol):
            def entry(dims, cluster):
                asked.append((self.name, symbol, list(dims), cluster))
                return 5
            entry.__name__ = symbol
            return entry

    libs = {}
    monkeypatch.setattr(_build, "load_library", lambda name: libs.setdefault(name, Lib(name)))
    cfm = dataclasses.replace(MP2018, local_dim=256, global_dim=256, dense_out=256)
    b16 = dataclasses.replace(cfm, dtype="bfloat16")
    assert kfwd.max_active_clusters(cfm, 4, 32, 16, 8) == 5
    assert kfwd.max_active_clusters(b16, 4, 32, 16, 8, 2) == 5
    (lib, sym, dims, C), (_, _, dims16, _) = asked[:2]
    assert (lib, sym, C) == ("scann_forward_d256", "scann_forward_d256_max_clusters", 8)
    assert dims == kfwd.launch_dims(cfm, 4, 32, 16) and len(dims) == 22
    assert (dims[20:], dims16[20:]) == ([0, 0], [2, 1])
    with open(f"{_build.SRC_DIR}/scann_forward.cu") as f:
        assert 'extern "C" int SCANN_FORWARD_ENTRY(max_clusters)(' in f.read()
