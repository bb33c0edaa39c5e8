"""Tall structures in the PyTorch port (kernels #3 and #4 at a narrow N with M
past the narrow builds' shared-memory plans: the centers in global memory)
against the JAX package on the CPU, in float32.

- The plans and gates: the tall plans drop the resident [M, max(D, G)]
  buffer, so they do not grow with M apart from the readout's vectors; #3's
  takes atom blocks of 32 again and two chunk operand buffers (the next
  chunk staged while one runs), #4's chunks of 64 rows with atom blocks of
  16 at D = 128 (the narrow plans keep chunks of 32 rows, the wide #4's
  sub-chunks of 64 rows without the resident buffer, and the narrow gates
  take what they took); ``forward_library`` / ``backward_library``
  name the tall build past the narrow plan and only there (``tall=True``
  forces it), the wide build at a wide N.
- The scratch of each build (``loop_forward_scratch``,
  ``loop_backward_scratch``), a kept scratch of another build refused, and
  the launch arguments with a stub in place of the CUDA library.
- The CUDA sources: the narrow and wide builds take ``kTall = false``, the
  two tall sources define it, only they take 64-row chunks and the tall-only
  helpers, and the plans' terms.
- The plain versions against the JAX loop kernels in interpret mode at a
  tall shape, B = 1, M = 240, N = 8, one layer at the kernels' full width
  (D = G = 128, where the narrow plans stop below 240; a narrower model's
  narrow plan takes more atoms than the JAX kernels' VMEM gate at that
  width), SCANN+ and SCANN: #3 (``loop_scann_forward``) and #4
  (``loop_scann_train_grads`` at dropout 0.1 with attention dropout, on the
  JAX kernel's own masks). Tolerances: rtol 1e-5 / atol 1e-6, gradients
  2e-5 x max.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import jit_init_vars
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.kernels import scann_loop as jax_loop
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu_torch.compat import params_from_jax
from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.kernels import _build
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.models import init_params
from test_torch_stash import _interpreted, _jax_masks
from test_torch_wide import GRAD_TOL, SMALL, _flat, _stub, _wide_batch

torch.set_num_threads(1)

WIDE = dict(local_dim=128, num_head=8, global_dim=128, dense_out=128, scale=0.5,
            use_attn_norm=True, use_ga_norm=True)
CONFIGS = {
    "qm9": ModelConfig(n_atoms=10, embedding_dim=48, n_attention=7, g_update=True,
                       gaussian_d=4.0, **WIDE),
    "mp2018": ModelConfig(n_atoms=95, embedding_dim=128, n_attention=9, g_update=True,
                          gaussian_d=6.0, **WIDE),
    "ptgp": ModelConfig(n_atoms=80, embedding_dim=48, n_attention=11, use_ring=True,
                        g_update=False, gaussian_d=4.0, **WIDE),
}
MP2018 = CONFIGS["mp2018"]
r4 = lambda v: -(-v // 4) * 4


def _narrow_edge(plan_bytes):
    """The largest M whose narrow plan fits a block."""
    return max(M for M in range(1, 400) if plan_bytes(M) <= kfwd.MAX_SHARED_BYTES)


# --- plans, gates, builds -----------------------------------------------------------------

def _plan_32(cfm, M, N, S=0, resident=True, wide_rows=32):
    """The loop backward's plan with chunks of at most 32 rows, term by term
    as ``make_plan`` adds them: what the narrow build runs (with the
    resident [M, wd] buffer, or without it, ``resident``); at a wide N with
    sub-chunks of ``wide_rows`` rows."""
    D, G, O, H = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.num_head
    wd = max(D, G)
    lde = r4(cfm.embedding_dim + (10 if cfm.use_ring else 0))
    ldf = r4(kbwd.CGCNN_FEATURES) if cfm.feature == "cgcnn" else 0
    wide = N > 32
    for block in (32, 16, 8, 4) if wide else (32, 16, 8):
        block = min(block, M)
        ca = 1 if wide else max(1, min(block, 32 // N))
        rows = wide_rows
        chunk = (rows * (2 * D + 4) + 3 * rows * (D + 4) + 2 * r4(N * H) + r4(rows * H) + wd
                 if wide else ca * N * (2 * D + 4) + 3 * ca * N * (D + 4) + 3 * r4(ca * N * H))
        work = max(chunk, 5 * block * wd + r4(block), block * (2 * lde + ldf) + block * wd,
                   block * wd + 4 * wd + 5 * r4(M) + 3 * r4(O) + 4)
        if S:
            work = max(work, block * wd + kfwd.seg_backward_floats(S, wd, M, O))
        floats = (M * wd if resident else 0) + 5 * block * wd + work + 8 * 2 * wd + 2 * wd
        if 4 * floats <= kfwd.MAX_SHARED_BYTES:
            break
    return ca, block, 4 * floats


def _plan_wide(cfm, M, N, S=0):
    """The wide loop backward's plan: sub-chunks of 64 rows of one atom and
    no resident buffer, term by term as ``make_plan`` adds them."""
    return _plan_32(cfm, M, N, S, resident=False, wide_rows=kloop.WIDE_CHUNK_ROWS)


@pytest.mark.parametrize("N", [8, 16, 24, 32, 48, 64])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_torch_tall_plans_do_not_grow_with_m(name, N):
    """Past the narrow plans, the tall plans take the same atom blocks and
    bytes at every M up to thousands of atoms (#3 blocks of 32 and two chunk
    operand buffers; #4 chunks of 64 rows and blocks of 16 at D = 128, 32 at
    N = 24, whose chunk is 48 rows): only the readout's vectors (2 [M] in
    #3, 5 in #4) grow, and they take over the work region only where they
    outgrow a chunk's buffers (#3: past M = 18880).
    The narrow plans of #4 keep chunks of 32 rows; its wide plans take
    sub-chunks of 64 rows without the resident buffer."""
    cfm = CONFIGS[name]
    wd, O = 128, cfm.dense_out
    fwd = [kloop.loop_memory_plan(cfm, M, N, tall=True) for M in (240, 600, 1000, 4000)]
    assert len({p for p in fwd}) == 1 and fwd[0][1] == 32
    chunk_atoms, block, work, nbytes = fwd[0]
    assert nbytes == 4 * (2 * 32 * (wd + 4) + work)
    big = 20000       # the readout's [AB, wd] block and vectors outgrow a chunk's buffers
    assert kloop.loop_memory_plan(cfm, big, N, tall=True) == (
        chunk_atoms, 32, 32 * wd + 2 * wd + 2 * r4(big) + r4(O),
        4 * (2 * 32 * (wd + 4) + 32 * wd + 2 * wd + 2 * r4(big) + r4(O)))
    for M in (96, 200, 240, 600):
        assert kloop.loop_backward_memory_plan(cfm, M, N) == (
            _plan_wide(cfm, M, N) if N > kbwd.MAX_CHUNK_ROWS else _plan_32(cfm, M, N))
    if N > kbwd.MAX_CHUNK_ROWS:
        return
    bwd = [kloop.loop_backward_memory_plan(cfm, M, N, tall=True) for M in (240, 600, 1000, 3000)]
    assert len({p for p in bwd}) == 1
    chunk_atoms, block, nbytes = bwd[0]
    assert (chunk_atoms, block) == (kloop.TALL_CHUNK_ROWS // N, 32 if N == 24 else 16)
    lde = r4(cfm.embedding_dim + (10 if cfm.use_ring else 0))
    rest = 5 * block * wd + kbwd.N_WARPS * 2 * wd + 2 * wd
    assert nbytes - 4 * rest == 4 * max(kbwd.chunk_floats(chunk_atoms * N, 128, 8),
                                        5 * block * wd + block, block * wd + 4 * wd
                                        + 5 * r4(3000) + 3 * r4(O) + 4,
                                        block * 2 * lde + block * wd)
    big = 9000        # the readout outgrows a 64-row chunk, and blocks of 16 no longer fit
    rest8 = 5 * 8 * wd + kbwd.N_WARPS * 2 * wd + 2 * wd
    assert kloop.loop_backward_memory_plan(cfm, big, N, tall=True) == (
        min(8, kloop.TALL_CHUNK_ROWS // N), 8,
        4 * (rest8 + 8 * wd + 4 * wd + 5 * r4(big) + 3 * r4(O) + 4))
    # the narrow plans hold the resident buffer and keep chunks of 32 rows
    for M in (96, 200):
        assert kloop.loop_backward_memory_plan(cfm, M, N) == _plan_32(cfm, M, N)
        assert kloop.loop_backward_memory_plan(cfm, M, N, tall=True) != _plan_32(
            cfm, M, N, resident=False)


@pytest.mark.parametrize("N", [8, 16, 24, 32])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_torch_tall_backward_chunks_of_64_rows(name, N):
    """#4's tall plan at every M from 240 to 4000 and S up to
    ``backward_max_segments``: a chunk of ``(64 // N) * N`` rows, at most
    64, within a block's shared memory; the narrow plans at the same shapes
    keep chunks of 32 rows, the wide ones sub-chunks of 64 rows without the
    resident buffer, and every narrow gate takes what it took with them."""
    cfm = CONFIGS[name]
    for M in (240, 322, 444, 600, 968, 1500, 2500, 4000):
        S_max = kloop.backward_max_segments(cfm, M, N)
        for S in sorted({0, 1, 8, S_max}):
            chunk_atoms, block, nbytes = kloop.loop_backward_memory_plan(cfm, M, N, S, tall=True)
            assert chunk_atoms * N == (kloop.TALL_CHUNK_ROWS // N) * N <= 64
            assert chunk_atoms <= block and nbytes <= kfwd.MAX_SHARED_BYTES, (M, S)
            assert kloop.loop_backward_memory_plan(cfm, M, N, S) == _plan_32(cfm, M, N, S)
            # the gate's bytes: the tall plan fits wherever the 32-row one did
            assert ((_plan_32(cfm, M, N, S, resident=False)[2] <= kfwd.MAX_SHARED_BYTES)
                    == (kloop.backward_refusal(cfm, M, N, S) is None))
            if kloop.is_tall_backward(cfm, M, N, S):
                assert kloop.backward_plan(cfm, M, N, S) == (chunk_atoms, block, nbytes)
        for Nw in (48, 96):
            assert kloop.loop_backward_memory_plan(cfm, M // 4, Nw) == _plan_wide(cfm, M // 4, Nw)


@pytest.mark.parametrize("N", [8, 16, 24, 32, 48, 64, 96])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_torch_tall_builds_only_past_the_narrow_plan(name, N):
    """``forward_library`` and ``backward_library`` name the tall build one
    atom past the narrow plan's edge and not at it; a wide N takes the wide
    build at any M; ``tall=True`` forces the tall build at a narrow N,
    where #3 keeps the gate's plan (``forward_plan``, the narrow one) and #4
    runs its tall plan (``backward_plan(..., tall=True)``)."""
    cfm = CONFIGS[name]
    edge3 = _narrow_edge(lambda M: kloop.loop_memory_plan(cfm, M, N)[3])
    if kloop.is_wide_forward(cfm, N):
        assert kloop.forward_library(cfm, edge3 + 1, N, tall=True)[0] == "scann_loop_wide"
    else:
        assert kloop.forward_library(cfm, edge3, N) == ("scann_loop", "scann_loop_forward")
        assert kloop.forward_library(cfm, edge3 + 1, N) == ("scann_loop_tall",
                                                            "scann_loop_forward_tall")
        assert kloop.forward_library(cfm, 96, N, tall=True)[0] == "scann_loop_tall"
        assert kloop.forward_plan(cfm, edge3, N) == kloop.loop_memory_plan(cfm, edge3, N)
        assert kloop.forward_plan(cfm, edge3 + 1, N) == kloop.loop_memory_plan(
            cfm, edge3 + 1, N, tall=True)
        assert kloop.refusal(cfm, edge3 + 1, N) is None and kloop.refusal(cfm, 968, N) is None
    edge4 = _narrow_edge(lambda M: kloop.loop_backward_memory_plan(cfm, M, N)[2])
    if kloop.is_wide_backward(cfm, N):
        assert kloop.backward_library(cfm, edge4 + 1, N, tall=True) == "scann_loop_backward_wide"
        assert not kloop.is_tall_backward(cfm, edge4 + 1, N)
    else:
        assert kloop.backward_library(cfm, edge4, N) == "scann_loop_backward"
        assert kloop.backward_library(cfm, edge4 + 1, N) == "scann_loop_backward_tall"
        assert kloop.backward_library(cfm, 96, N, tall=True) == "scann_loop_backward_tall"
        assert kloop.backward_plan(cfm, edge4, N) == kloop.loop_backward_memory_plan(
            cfm, edge4, N)
        assert kloop.backward_plan(cfm, edge4 + 1, N) == kloop.loop_backward_memory_plan(
            cfm, edge4 + 1, N, tall=True)
        assert kloop.backward_plan(cfm, 96, N, tall=True) == kloop.loop_backward_memory_plan(
            cfm, 96, N, tall=True) != kloop.backward_plan(cfm, 96, N)
        assert kloop.backward_refusal(cfm, edge4 + 1, N) is None
        assert kloop.backward_refusal(cfm, 968, N) is None
    # bf16 operands: the same builds at the same edges, #4's in their bf16 sources
    b16 = dataclasses.replace(cfm, dtype="bfloat16")
    if not kloop.is_wide_backward(cfm, N):
        assert kloop.backward_library(b16, edge4, N) == "scann_loop_backward_bf16"
        assert kloop.backward_library(b16, edge4 + 1, N) == "scann_loop_backward_tall_bf16"
        assert kloop.backward_library(b16, 96, N, tall=True) == "scann_loop_backward_tall_bf16"
        assert kloop.backward_refusal(b16, edge4 + 1, N) is None
        assert kloop.backward_plan(b16, edge4 + 1, N) == kloop.backward_plan(cfm, edge4 + 1, N)
    else:
        assert kloop.backward_library(b16, edge4 + 1, N) == "scann_loop_backward_wide_bf16"
    if not kloop.is_wide_forward(cfm, N):
        assert kloop.refusal(b16, edge3, N) is None
        assert kloop.refusal(b16, edge3 + 1, N) is None
        assert kloop.forward_library(b16, edge3 + 1, N) == kloop.forward_library(cfm, edge3 + 1, N)


def test_torch_tall_packed_segments_fit():
    """Packed slots in the tall builds: the per-segment vectors fit beside a
    chunk's buffers up to the largest S at tall capacities, so the gates
    take them."""
    for M in (300, 573, 968):
        assert kloop.max_segments(MP2018, M, 16) == kfwd.MAX_SEGMENTS
        assert kloop.backward_max_segments(MP2018, M, 16) == kfwd.MAX_SEGMENTS
        assert kloop.refusal(MP2018, M, 32, 8) is None
        assert kloop.backward_refusal(MP2018, M, 32, 8) is None
        assert kloop.is_tall(MP2018, M, 32, 8) and kloop.is_tall_backward(MP2018, M, 32, 8)


# --- scratch and launch arguments --------------------------------------------------------------

def test_torch_tall_scratch_sizes():
    """The scratch of each build: #3's new centers [B, M, D] narrow, a
    ping-pong [2, B, M, D] tall beside the readout rows [B, M, 2G] (each
    atom's GA keys and queries, whatever C); #4's tall
    scratch [B * C, M, G + D] (GA keys, then the d(layer input) partial),
    None in the narrow build; the wide #4 takes it too, with its rows of one
    atom [B * C, 3, N, D] right after it in the same allocation."""
    cfm = dataclasses.replace(MP2018, global_dim=64)
    B, N, D, G = 3, 16, 128, 64
    packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0), "cpu"), cfm)
    for M, C, tall in ((96, 4, False), (300, 4, True), (300, 2, True), (96, 1, True)):
        assert kloop.is_tall(cfm, M, N) == (M > 200)
        f = kloop.loop_forward_scratch(cfm, B, M, N, "cpu", C, tall=tall if M < 200 else None)
        assert tuple(f["next_centers"].shape) == ((2, B, M, D) if tall else (B, M, D))
        assert (f["readout"] is None) != tall and f["wide_keys"] is None
        if tall:
            assert tuple(f["readout"].shape) == (B, M, 2 * G)
        s = kloop.loop_backward_scratch(packed, cfm, B, M, N, C, None,
                                        tall=tall if M < 200 else None)
        assert (s["tall"] is None) != tall and s["wide_rows"] is None
        if tall:
            assert tuple(s["tall"].shape) == (B * C, M, G + D)
        assert tuple(s["dcenters"].shape) == (B, M, D) and s["rows"].shape[0] == B * C
    wide = kloop.loop_backward_scratch(packed, cfm, B, 96, 48, 2, None)
    assert tuple(wide["tall"].shape) == (B * 2, 96, G + D)
    assert tuple(wide["wide_rows"].shape) == (B * 2, 3, 48, D)
    assert wide["wide_rows"].data_ptr() == wide["tall"].data_ptr() + 4 * wide["tall"].numel()


# clusters of 1 to 16 blocks the card runs at once, as the H100 reported them
# for both builds (``cudaOccupancyMaxActiveClusters``)
AT_ONCE = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9, 10: 7, 11: 7,
           12: 7, 13: 7, 14: 7, 15: 7, 16: 7}


@pytest.mark.parametrize("B,want", [(1, 16), (7, 16), (8, 9), (16, 6), (30, 4), (64, 2),
                                    (67, 1)])
@pytest.mark.parametrize("M,N", [(322, 32), (80, 96)])
def test_torch_forward_cluster_fills_the_card(B, want, M, N, monkeypatch):
    """The tall and wide #3 launch the largest of 16 ... 1 blocks per
    structure whose B clusters run at once by the launched build's own
    ``max_active_forward_clusters`` (16 for one structure, 6 at B = 16
    where 15 clusters of 8 or 7 fit, 2 at the recipe batch of 64); the
    narrow #3 and every #4 build keep ``cluster_size(B)``, whose sizes they
    take (a launch outside them is refused)."""
    asked = []

    def at_once(cfm, B_, M_, N_, C, S=0, tall=False):
        asked.append((kloop.forward_library(cfm, M_, N_, S, tall)[0], C))
        return AT_ONCE[C]

    monkeypatch.setattr(kloop, "max_active_forward_clusters", at_once)
    cfm = MP2018
    assert kloop.is_tall(cfm, M, N) or kloop.is_wide_forward(cfm, N)
    assert kloop.forward_cluster(cfm, B, M, N) == want
    assert {lib for lib, _ in asked} == {kloop.forward_library(cfm, M, N)[0]}
    assert asked[0][1] == 16 and asked[-1][1] == want
    # the narrow #3 (and a forced tall launch at a narrow shape asks the tall build)
    del asked[:]
    assert kloop.forward_cluster(cfm, B, 96, 32) == kloop.cluster_size(B) and not asked
    kloop.forward_cluster(cfm, B, 96, 32, tall=True)
    assert {lib for lib, _ in asked} == {"scann_loop_tall"}
    assert kloop.cluster_size(B) in kloop.CLUSTER_SIZES == (4, 2, 1)
    assert kloop.FORWARD_CLUSTER_SIZES == tuple(range(16, 0, -1))


def test_torch_forward_cluster_sizes_in_the_sources():
    """The tall and wide builds' launcher takes up to 16 blocks a structure
    and opts into the non-portable sizes past 8 (the launch and the
    occupancy query alike); the narrow build keeps its 4."""
    with open(f"{_build.SRC_DIR}/scann_loop.cu") as f:
        src = f.read()
    assert "constexpr int kMaxCluster = 4;" in src and "constexpr int kMaxL2Cluster = 16;" in src
    assert ("constexpr int kBuildMaxCluster = (kWideBuild || kTall) ? kMaxL2Cluster : "
            "kMaxCluster;") in src
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in src
    assert src.count("set_kernel_attributes((const void*)kernel, bytes)") == 2
    assert "C < 1 || C > kBuildMaxCluster ||" in src


@pytest.mark.parametrize("M,N,tall", [(322, 32, True), (96, 32, False), (80, 96, True)])
def test_torch_scann_rbf_table_scratch(M, N, tall):
    """SCANN (no geometry) in the tall and wide builds: the geometry scratch
    holds the distance RBF table [B * M * N * round4(K)], which each launch
    forms once for all layers and the staging copies from; the narrow build
    keeps none. A kept scratch without it is refused."""
    cfm = dataclasses.replace(CONFIGS["ptgp"], n_attention=1)
    B = 2
    f = kloop.loop_forward_scratch(cfm, B, M, N, "cpu", 2)
    l2 = kloop.is_tall(cfm, M, N) or kloop.is_wide_forward(cfm, N)
    assert l2 == tall
    assert (f["geo"] is None) != tall
    if tall:
        assert tuple(f["geo"].shape) == (B * M * N * r4(cfm.num_gaussian),)
    with open(f"{_build.SRC_DIR}/scann_loop.cu") as src:
        text = src.read()
    assert "if (!a.g_update) rbf_b = a.geo + (size_t)b * M * N * round4(a.K);" in text


@pytest.mark.parametrize("M,force", [(96, False), (96, True), (300, False)])
def test_torch_tall_launch_arguments(M, force, monkeypatch):
    """A tall launch (past the narrow plan, or ``tall=True``) calls the tall
    builds with their scratch in the last pointer slot (#3's readout rows
    [B, M, 2G], #4's per-block [B * C, M, G + D]), the ping-pong centers in
    #3's slot 49, each at the plan of the build it calls (a forced launch:
    the tall plan's chunk buffers and atom block), and counts
    ``.tall_launches``; a kept scratch of the other build is refused."""
    calls = _stub(monkeypatch)
    for launcher in (kloop.launch_loop_forward, kloop.launch_loop_backward):
        monkeypatch.setattr(launcher, "tall_launches", 0)
    cfm = dataclasses.replace(MP2018, n_attention=1, embedding_dim=8)
    B, N = 2, 16
    x = {k: torch.from_numpy(v)
         for k, v in _wide_batch(np.random.default_rng(M), B, M, N).items()}
    packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0), "cpu"), cfm)
    tall = force or M > 237
    kloop._launch(packed, x, cfm, False, 0.0, 0, 0, 2, tall=force)
    kloop._launch_backward(packed, x, cfm, torch.zeros(B, 1), None, True, cluster=2, stash=None,
                           tall=force)
    (lib_f, sym_f, t_f, d_f), (lib_b, sym_b, t_b, d_b) = calls
    assert (lib_f, sym_f) == (("scann_loop_tall", "scann_loop_forward_tall") if tall
                              else ("scann_loop", "scann_loop_forward"))
    assert lib_b == sym_b == ("scann_loop_backward_tall" if tall else "scann_loop_backward")
    assert len(t_f) == 52 and len(t_b) == 60
    assert tuple(t_f[49].shape) == ((2, B, M, 128) if tall else (B, M, 128))
    for keys, shape in ((t_f[-1], (B, M, 2 * 128)), (t_b[-1], (B * 2, M, 128 + 128))):
        assert (keys is None) != tall
        if tall:
            assert tuple(keys.shape) == shape and keys.dtype == torch.float32
    assert (d_f[16], d_f[20], d_f[17]) == tuple(kloop.forward_plan(cfm, M, N, tall=force)[:3])
    assert (d_b[18], d_b[21]) == kloop.backward_plan(cfm, M, N, tall=force)[:2]
    if force:     # the tall plans' chunk buffers, chunk and atom block
        assert (d_f[16], d_f[20], d_f[17]) == kloop.l2_memory_plan(cfm, M, N)[:3]
        assert d_f[17] != kloop.loop_memory_plan(cfm, M, N)[2]
        assert (d_b[18], d_b[21]) == kloop.loop_backward_memory_plan(cfm, M, N, tall=True)[:2]
        assert (d_b[18], d_b[21]) != kloop.loop_backward_memory_plan(cfm, M, N)[:2]
    assert kloop.launch_loop_forward.tall_launches == tall
    assert kloop.launch_loop_backward.tall_launches == tall
    other = not tall
    with pytest.raises(ValueError, match="scratch"):
        kloop._launch(packed, x, cfm, False, 0.0, 0, 0, 2,
                      kloop.loop_forward_scratch(cfm, B, M, N, "cpu", 2, tall=other), tall=force)
    with pytest.raises(ValueError, match="scratch"):
        kloop._launch_backward(packed, x, cfm, torch.zeros(B, 1), None, True,
                               scratch=kloop.loop_backward_scratch(packed, cfm, B, M, N, 2, None,
                                                                   tall=other),
                               cluster=2, stash=None, tall=force)
    # bf16 operands: the same tall build of #3 with the mode flag, #4's bf16 tall build
    b16 = dataclasses.replace(cfm, dtype="bfloat16")
    del calls[:]
    kloop._launch(packed, x, b16, False, 0.0, 0, 0, 2, tall=force)
    kloop._launch_backward(packed, x, b16, torch.zeros(B, 1), None, True, cluster=2, stash=None,
                           tall=force)
    (lib_f, _, t_f, d_f), (lib_b, sym_b, t_b, d_b) = calls
    assert lib_f == ("scann_loop_tall" if tall else "scann_loop") and d_f[22] == 1
    assert lib_b == sym_b == ("scann_loop_backward_tall_bf16" if tall
                              else "scann_loop_backward_bf16")
    assert (t_f[-1] is None) != tall and (t_b[-1] is None) != tall
    assert kloop.launch_loop_forward.tall_launches == 2 * tall
    assert kloop.launch_loop_backward.tall_launches == 2 * tall


def test_torch_tall_sources():
    """The narrow and wide builds take ``kTall = false``: only the tall
    sources (#4's in both modes) define the macro that sets it, each
    includes its narrow source, and the plans drop the resident rows only
    under it."""
    src = {}
    for name in ("scann_loop", "scann_loop_backward") + _build.SHAPE_SOURCES + \
            ("scann_loop_backward_bf16",):
        with open(f"{_build.SRC_DIR}/{name}.cu") as f:
            src[name] = f.read()
    assert _build.TALL_SOURCES == ("scann_loop_tall", "scann_loop_backward_tall")
    assert not set(_build.TALL_SOURCES) & set(_build.SOURCES + _build.WIDE_SOURCES)
    for narrow, macro in (("scann_loop", "SCANN_LOOP_TALL"),
                          ("scann_loop_backward", "SCANN_LOOP_BACKWARD_TALL")):
        text = src[narrow]
        assert (f"#ifdef {macro}\nconstexpr bool kTall = true;\n#else\n"
                "constexpr bool kTall = false;\n#endif") in text
        assert f"#define {macro}\n#include \"{narrow}.cu\"" in src[narrow + "_tall"]
        assert _build.source_files(narrow + "_tall")[1].endswith(f"/{narrow}.cu")
        for other, body in src.items():
            if not other.startswith(narrow + "_tall"):
                assert f"#define {macro}" not in body, other
    assert ('#define SCANN_LOOP_BACKWARD_TALL\n#define SCANN_LOOP_BACKWARD_BF16\n'
            '#include "scann_loop_backward.cu"') in src["scann_loop_backward_tall_bf16"]
    plan = src["scann_loop"][src["scann_loop"].index("inline Plan make_plan("):]
    assert "if constexpr (kTall || kWide) {" in plan and "p.offQ = a.M * p.wd;" in plan
    assert "p.offQ = 0;" in src["scann_loop"][src["scann_loop"].index("inline L2Plan l2_plan("):]
    assert "p.offBlk = kTall || kWide ? 0 : a.M * p.wd;" in src["scann_loop_backward"]
    # only the tall builds take chunks of 64 rows of several atoms: the narrow
    # build keeps kMaxChunkRows = 32 (the launcher's cap); the wide build takes
    # sub-chunks of 64 rows of one atom
    bwd = src["scann_loop_backward"]
    assert "constexpr int kMaxChunkRows = 32;" in bwd
    assert "constexpr int kTallChunkRows = 64;" in bwd
    assert "constexpr int kWideChunkRows = 64;" in bwd
    assert "p.rows = kWide ? wide_rows : a.chunk_atoms * a.N;" in bwd
    assert "inline Plan make_plan(const Args& a, int wide_rows = kWideChunkRows) {" in bwd
    assert "a.chunk_atoms * a.N > (kTall ? kTallChunkRows : kMaxChunkRows)" in bwd
    # the wide build takes N past kTallMaxN: kMaxChunkRows up to 256 columns
    assert "(a.N > kTallMaxN) != kWide" in bwd
    assert "constexpr int kTallMaxN = kD512 ? 16 : kMaxChunkRows;" in bwd
    assert (kloop.TALL_CHUNK_ROWS, kbwd.MAX_CHUNK_ROWS) == (64, 32)
    # the tall build's own helpers run only under kTall (the scatter and the
    # small weight gradient under kHomes, kTall || kWide: the wide build's
    # global homes too), each beside the narrow code it stands in for
    kernel = bwd[bwd.index("scann_loop_backward_kernel(const Args a"):bwd.index("void set_dims")]
    assert "constexpr bool kHomes = kTall || kWide;" in kernel
    for call, under in (("tall_scatter<kBf16>(", "kHomes"),
                        ("tall_energy_softmax<kBf16>(", "kTall"),
                        ("tall_softmax_backward<kBf16>(", "kTall"),
                        ("tall_gemm_tA<kBf16>(", "kHomes")):
        at = kernel.index(call)
        assert kernel.rfind(f"if constexpr ({under})", 0, at) > kernel.rfind("} else", 0, at), call
    assert kernel.count("warp_energy_softmax<kBf16>(") == 2
    assert kernel.count("warp_softmax_backward<kBf16>(") == 2
    for other in ("scann_mma.cuh", "scann_loop.cu", "scann_backward.cu"):
        with open(f"{_build.SRC_DIR}/{other}") as f:
            text = f.read()
        assert not any(w in text for w in ("kTallChunkRows", "tall_scatter", "tall_gemm_tA",
                                           "tall_energy_softmax"))
    # the tall builds take both operand modes and want their scratch
    assert "(kTall && bf16)" not in src["scann_loop"]
    assert "(l2 != nullptr) != (kWideBuild || kTall)" in src["scann_loop"]
    assert "(wide_keys != nullptr) != (kWide || kTall)" in src["scann_loop_backward"]
    # the tall and wide #3 gather by bulk copies through L2 (other SMs wrote
    # the rows), a chunk staged while the one before it runs (tall)
    with open(f"{_build.SRC_DIR}/scann_forward_common.cuh") as f:
        common = f.read()
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes" in common
    assert src["scann_loop"].count("fwd_stage_chunk_bulk(") == 1
    assert "if (n0 < m_hi) stage(cur ^ 1, ring_idx(cur ^ 1), n0 * N, chunk_atoms(n0) * N);" in (
        src["scann_loop"])


# --- the plain versions at a tall shape against the JAX kernels ---------------------------

TALL_CASES = {"scann+": dict(g_update=True), "scann ring": dict(g_update=False, use_ring=True)}
TALL_M, TALL_N = 240, 8


def _tall_setup(seed, dropout=False, **kw):
    """One structure of 240 atoms, 8 neighbours, one layer at D = G = 128
    (the narrow plans stop below 240 atoms there)."""
    widths = dict(SMALL, n_attention=1, local_dim=128, num_head=8, global_dim=128)
    jcfg = JaxModelConfig(**widths, use_drop=dropout, **kw)
    tcfg = ModelConfig(**widths, use_drop=dropout, **kw)
    x = _wide_batch(np.random.default_rng(seed), 1, TALL_M, TALL_N, tcfg.use_ring)
    jparams = jax.device_get(jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(seed),
                                           x))
    assert kloop.is_tall(tcfg, TALL_M, TALL_N) and kloop.is_tall_backward(tcfg, TALL_M, TALL_N)
    assert kloop.refusal(tcfg, TALL_M, TALL_N) is None
    assert kloop.backward_refusal(tcfg, TALL_M, TALL_N) is None
    assert jax_loop.fits_loop_vmem(jcfg, TALL_M, TALL_N, training=True)
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    return jcfg, tcfg, jparams, params_from_jax(jparams, tcfg), x, tx


@pytest.mark.parametrize("case", list(TALL_CASES))
def test_torch_tall_loop_forward_matches_jax_kernel(case):
    """#3's plain version (``loop_scann_forward`` on CPU tensors) at a tall
    shape against the JAX loop forward in interpret mode."""
    jcfg, tcfg, jp, tp, x, tx = _tall_setup(18, **TALL_CASES[case])
    want_pred, want_ga = jax_loop.loop_scann_forward(jp, x, jcfg, interpret=True)
    with torch.no_grad():
        pred, ga = kloop.loop_scann_forward(tp, tx, tcfg)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ga.numpy(), np.asarray(want_ga), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", list(TALL_CASES))
def test_torch_tall_loop_train_grads_match_jax_kernel(case, monkeypatch):
    """#4's plain version (``loop_scann_train_grads`` on CPU tensors) at a
    tall shape against the JAX loop backward in interpret mode, at dropout
    0.1 with attention dropout on the JAX kernel's own masks."""
    rate = 0.1
    jcfg, tcfg, jp, tp, x, tx = _tall_setup(19, dropout=True, **TALL_CASES[case])
    masks = _jax_masks("loop", 42, 1, TALL_M, TALL_N, tcfg, rate)
    monkeypatch.setattr(kbwd, "dropout_masks_for", lambda *a, **k: masks)
    y = np.random.default_rng(5).normal(size=(1, 1)).astype(np.float32)
    with _interpreted(rate) as interpret:
        want_pred, want = jax_loop.loop_scann_train_grads(jp, x, y, jcfg, interpret=interpret,
                                                          dropout_rate=rate, dropout_seed=42)
    pred, got = kloop.loop_scann_train_grads(tp, tx, torch.from_numpy(y), tcfg,
                                             dropout_rate=rate, dropout_seed=42)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred).reshape(1, -1), rtol=1e-5,
                               atol=1e-6)
    want = _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                                   atol=GRAD_TOL * (np.abs(w).max() + 1e-8),
                                   err_msg=f"gradient of {k}")
