"""The wide forward builds redesigned at 256 columns, the wide #3
(``csrc/scann_loop_wide_d256.cu``) and the wide #5
(``csrc/local_attention_wide_d256.cu``), on the CPU: their plans, what their
launches are handed, and their plain versions against the JAX package.

- The plans, as the Python mirrors compute them (``kloop.l2_memory_plan``,
  ``kla.wide_block_plan`` / ``make_plan``): each atom's rows in sub-chunks
  of 32 in two operand buffers [32, 2D + 4] (what one buffer of 64 rows
  took at D = 256), term by term against a model of the CUDA sources'
  terms and within 232,448 B, at MP2018 (16, 80, 96) and (8, 96, 96) and at
  the sub-chunk edges N = 33, 64, 65, 96, 97 and 256; the terms as the
  sources write them; the wide #5 taking every shape its one-buffer plan
  took; up to 128 columns the plans of 64-row sub-chunks as they were.
- The launches (a stub in place of the CUDA library): the wide #5's key
  scratch where its plan keeps the keys in L2 (every N > 64 at D = 256),
  its planes and plan; the wide #3's key scratch where its plan has one.
- The plain versions at the sub-chunk edges against the JAX kernels in
  interpret mode, rtol 1e-5 / atol 1e-6 (#5's updated geometry at atol
  2e-6, ``GEO_ATOL`` of ``tests/test_torch_d256_forward.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.kernels import local_attention as jla
from scann_tpu.kernels.scann_loop import loop_scann_forward as jax_loop_forward
from scann_tpu_torch.kernels import _build
from scann_tpu_torch.kernels import local_attention as kla
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.kernels import widths
from test_torch_widths import MP2018, _flat_params, _layer_inputs, _setup, _torch

torch.set_num_threads(1)

RTOL, ATOL, GEO_ATOL = 1e-5, 1e-6, 2e-6
EDGES = (33, 64, 65, 96, 97, 256)   # one row past a sub-chunk, two whole ones, ...
r4 = lambda v: -(-v // 4) * 4


def _layer_terms(AB, N, D, H, g_update, bf16):
    """wide_d256_block_plan of csrc/local_attention.cu, term by term:
    (operand buffers, keys in shared memory, shared bytes)."""
    rows = 32
    slots = (2 if g_update else 1) * AB * (D + 4)
    off_a = max(rows * (D + 4) + r4(N * H), AB * (D + 4))
    for keys in (True, False):
        off_i = off_a + 2 * rows * (2 * D + 4) + (rows * D if bf16 else 0)
        total = slots + off_i + r4(2 * N) + (N * D if keys else 0)
        if 4 * total <= kla.MAX_SHARED_BYTES:
            return 2, keys, 4 * total
    return None


def _parent_one_buffer(AB, N, D, H, g_update):
    """The shared bytes of the wide #5's plan before PR 26 with one 64-row
    buffer and the keys in L2 (its smallest layout), as ``wide_block_plan``
    computes it up to 128 columns."""
    off_a = max(64 * (D + 4) + r4(N * H), AB * (D + 4))
    return 4 * ((2 if g_update else 1) * AB * (D + 4) + off_a + 64 * (2 * D + 4) + r4(2 * N))


def _loop_terms(cfm, M, N, block, keys):
    """l2_plan<true> of csrc/scann_loop.cu past 128 columns, term by term:
    (atoms per chunk, atom block, work floats, shared bytes, keys)."""
    D, G, O, H = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.num_head
    wd, rows = max(D, G), 32
    front = max(rows * (D + 4) + r4(N * H), block * (wd + 4))
    work = front + 2 * rows * (2 * D + 4) + r4(2 * N) + 4 + (N * D if keys else 0)
    work = max(work, block * r4(cfm.embedding_dim), block * wd + 2 * wd + 2 * r4(M) + r4(O))
    return 1, block, work, 4 * (2 * block * (wd + 4) + work), keys


# --- plans -----------------------------------------------------------------------

@pytest.mark.parametrize("N", EDGES[2:] + (81, 128))
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("g_update", [True, False])
def test_torch_d256_wide_layer_plan_terms(N, bf16, g_update):
    """#5's wide plan past 128 columns at every atom block: the sources'
    terms, two 32-row buffers (with a bf16 raw area on bfloat16 tensors)
    within a block's shared memory, the keys in L2 at D = 256 and N > 61."""
    for AB in kla.WIDE_ATOM_BLOCKS:
        plan = kla.wide_block_plan(AB, N, 256, 8, g_update, bf16)
        assert plan == _layer_terms(AB, N, 256, 8, g_update, bf16), AB
        if AB <= 8:
            assert plan[0] == 2 and plan[2] <= kla.MAX_SHARED_BYTES and not plan[1], AB
    for B, M in ((1, 48), (8, 96), (64, 96), (2, 73)):
        ab, ca, nbytes = kla.make_plan(B, M, N, 256, 8, g_update, 132, bf16)
        assert ca == 1 and (2, False, nbytes) == kla.wide_block_plan(ab, N, 256, 8, g_update, bf16)


def test_torch_d256_wide_layer_plan_at_main_shapes():
    """The timed shapes: (1, 48, 96) one atom a block, (8, 96, 96) two (384
    blocks, 3 waves), (64, 96, 96) sixteen on f32 tensors; on bfloat16
    tensors 16 atoms leave no room for the raw area beside two buffers, so
    the plan takes 8. The parent's layout at (8, 96, 96), one buffer of 64
    rows, took 206,656 B."""
    assert kla.make_plan(1, 48, 96, 256, 8, True, 132) == (1, 1, 171296)
    assert kla.make_plan(8, 96, 96, 256, 8, True, 132) == (2, 1, 173376)
    assert kla.make_plan(8, 96, 96, 256, 8, True, 132, True) == (2, 1, 206144)
    assert kla.make_plan(64, 96, 96, 256, 8, True, 132) == (16, 1, 202496)
    assert kla.wide_block_plan(16, 96, 256, 8, True, True) is None
    assert kla.make_plan(64, 96, 96, 256, 8, True, 132, True) == (8, 1, 218624)
    assert _parent_one_buffer(2, 96, 256, 8, True) == 206656


@pytest.mark.parametrize("D,H", [(136, 1), (136, 34), (192, 8), (192, 48), (256, 8),
                                 (256, 64)])
def test_torch_d256_wide_layer_plan_fits_where_one_64_row_buffer_did(D, H):
    """Two 32-row buffers (and the bf16 raw area) take no more than the one
    64-row buffer and 64-row front they replace, so the wide #5 past 128
    columns takes every (atom block, N, H) its plan before PR 26 took."""
    for N in range(65, 257, 8):
        for AB in kla.WIDE_ATOM_BLOCKS:
            for g_update in (True, False):
                if _parent_one_buffer(AB, N, D, H, g_update) <= kla.MAX_SHARED_BYTES:
                    for bf16 in (False, True):
                        assert kla.wide_block_plan(AB, N, D, H, g_update, bf16) is not None


@pytest.mark.parametrize("N", EDGES)
@pytest.mark.parametrize("M", [80, 1000])
def test_torch_d256_wide_loop_plan_terms(N, M):
    """#3's wide plan past 128 columns: the first atom block of 32, 16, 8
    whose plan fits with the keys in shared memory, else without them; two
    32-row buffers; the sources' terms."""
    mp = dataclasses.replace(MP2018)
    plan = kloop.l2_memory_plan(mp, M, N)
    want = next((p for keys in (True, False) for block in kloop.ATOM_BLOCKS
                 for p in [_loop_terms(mp, M, N, min(block, M), keys)]
                 if p[3] <= kloop.MAX_SHARED_BYTES), None)
    assert plan == want and plan[3] <= kloop.MAX_SHARED_BYTES
    assert kloop.forward_plan(mp, M, N) == plan[:4]
    assert kloop.forward_library(mp, M, N) == ("scann_loop_wide_d256",
                                               "scann_loop_forward_wide_d256")
    # the sub-chunks' two buffers [32, 2D + 4] fit in the work region
    assert plan[2] >= 2 * 32 * (2 * 256 + 4)


def test_torch_d256_wide_loop_plan_at_mp2018():
    """MP2018 (16, 80, 96) at D = 256: atom blocks of 16 (8 with one 64-row
    buffer: 219,152 B), 202,512 B, the keys in L2; at N = 33 the keys fit
    beside two buffers at blocks of 8."""
    assert kloop.l2_memory_plan(MP2018, 80, 96) == (1, 16, 42308, 202512, False)
    assert kloop.l2_memory_plan(MP2018, 80, 33) == (1, 8, 50128, 217152, True)
    assert kloop.wide_keys_shape_for(MP2018, 16, 80, 96, 6) == (96, 96, 256)
    assert kloop.wide_keys_shape_for(MP2018, 16, 80, 33, 6) is None


def test_torch_d256_wide_plans_up_to_128_columns_unchanged():
    """Up to 128 columns the wide builds keep one 64-row sub-chunk buffer:
    MP2018 (16, 80, 96) takes the plan it took, and #5's wide plan at
    D = 128 its layouts."""
    mp = dataclasses.replace(MP2018, local_dim=128, global_dim=128, dense_out=128)
    wd, N, block = 128, 96, 32
    front = max(64 * 132 + r4(N * 8), block * (wd + 4))
    work = front + 64 * 260 + r4(2 * N) + 4 + N * 128
    assert kloop.l2_memory_plan(mp, 80, N) == (1, block, work, 4 * (2 * block * 132 + work), True)
    for AB in kla.WIDE_ATOM_BLOCKS:
        buffers, keys, nbytes = kla.wide_block_plan(AB, N, 128, 8, True)
        off_a = max(64 * 132 + r4(N * 8), AB * 132)
        assert nbytes == 4 * (2 * AB * 132 + off_a + buffers * 64 * 260 + r4(2 * N)
                              + (N * 128 if keys else 0))


def test_torch_d256_wide_plans_match_cuda_sources():
    """The CUDA sources' terms of the wide plans past 128 columns, which the
    Python mirrors above model."""
    with open(f"{_build.SRC_DIR}/scann_forward_common.cuh") as f:
        common = f.read()
    assert "constexpr int kFwdWideW32Rows = 32;" in common
    d256 = widths.class_of(256)
    assert d256.wide_forward_rows == 32 == d256.chunk_rows
    assert "constexpr int kSub = kW32 ? kFwdWideW32Rows : kFwdMaxChunkRows;" in common
    with open(f"{_build.SRC_DIR}/scann_loop.cu") as f:
        loop = f.read()
    for term in ("constexpr int kWideRows = kW32 ? kFwdWideW32Rows : kFwdMaxChunkRows;",
                 "constexpr int kWideBuffers = kW32 ? 2 : 1;",
                 "p.rows = kWide ? kWideRows : a.chunk_atoms * a.N;",
                 "q.offI = front + (kWide ? kWideBuffers : 2) * p.rows * (2 * a.D + 4);",
                 "by_row.chunk_atoms = kWideRows;"):
        assert term in loop, term
    with open(f"{_build.SRC_DIR}/local_attention.cu") as f:
        la = f.read()
    plan = la[la.index("inline WideD256Plan wide_d256_plan_for("):
              la.index("// The wide build's block past 128 columns")]
    for term in ("const int rows = kFwdWideW32Rows, buf = rows * (2 * D + 4);",
                 "const int front = rows * (D + 4) + round4(N * H), centers = AB * (D + 4);",
                 "p.offA = front > centers ? front : centers;",
                 "p.offA1 = p.offA + buf;", "p.offR = p.offA1 + buf;",
                 "p.offI = p.offR + (bf16 ? rows * D : 0);",
                 "p.offK = p.offI + round4(2 * N);",
                 "p.total = (g_update ? 2 : 1) * AB * (D + 4) + p.offK + (smem_keys ? N * D : 0);",
                 "for (int keys = 1; keys >= 0; --keys) {",
                 "if (best_cost < 0 || cost <= best_cost) {"):
        assert term in plan, term


# --- launches --------------------------------------------------------------------

@pytest.mark.parametrize("N", [65, 97, 256])
def test_torch_d256_wide_layer_launch_hands_the_key_scratch(N, monkeypatch):
    """The wide #5 past 128 columns is handed a key scratch [blocks, N, D]
    where its plan keeps the keys in L2 (every N > 64 at D = 256), the
    planes as pointer 19, and the plan's sizes."""
    seen = []
    monkeypatch.setattr(kfwd, "call_kernel", lambda *a, **k: seen.append(a))
    monkeypatch.setattr(kla, "sm_count", lambda dev: 132)
    c, i, g, m, w, p = _layer_inputs(np.random.default_rng(3), 2, 10, N, 256, True)
    kla._launch(*[torch.from_numpy(a) for a in (c, i, g, m, w)], _flat_params(p), 8, 0.5, True)
    lib, symbol, _, tensors, dims = seen[0][:5]
    assert (lib, symbol) == ("local_attention_wide_d256", "local_attention_wide_d256")
    ab, ca, nbytes = kla.make_plan(2, 10, N, 256, 8, True, 132)
    assert dims[8:] == [ab, ca, nbytes]
    assert not kla.wide_block_plan(ab, N, 256, 8, True)[1]
    assert tuple(tensors[18].shape) == (2 * -(-10 // ab), N, 256)
    assert tensors[19] is not None and len(tensors) == 20
    for name in ("launches", "bf16_launches", "wide_launches", "d256_launches"):
        setattr(kla.fused_local_attention, name, 0)


# --- the plain versions against the JAX kernels ------------------------------------

@pytest.mark.parametrize("N", [65, 97])
def test_torch_d256_wide_layer_plain_matches_jax_kernel(N):
    """#5's plain version at D = 256 and N one row past two and three 32-row
    sub-chunks."""
    rng = np.random.default_rng(N + 512)
    centers, idx, geometry, mask, weight, params = _layer_inputs(rng, 2, 4, N, 256, True)
    assert kla.library(N, 256) == "local_attention_wide_d256"
    want = jla._pallas_forward(*[jnp.asarray(a) for a in (centers, idx, geometry, mask, weight)],
                               params, 8, 0.5, True, interpret=True)
    with torch.no_grad():
        out, geo, attn = kla.fused_local_attention(
            *[torch.from_numpy(a) for a in (centers, idx, geometry, mask, weight)],
            _flat_params(params), 8, 0.5, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want[2]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(geo.numpy(), np.asarray(want[1]), rtol=RTOL, atol=GEO_ATOL)


def test_torch_d256_wide_loop_plain_matches_jax_kernel():
    """#3's plain version at D = G = O = 256 and N = 33, one row past a
    32-row sub-chunk, where the wide build past 128 columns takes the
    batch."""
    jcfg, tcfg, jp, tp, x = _setup("256", 41, M=6, N=33)
    assert kloop.forward_library(tcfg, 6, 33)[0] == "scann_loop_wide_d256"
    want = jax_loop_forward(jp, x, jcfg, interpret=True)
    with torch.no_grad():
        got = kloop.loop_scann_forward(tp, _torch(x), tcfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
