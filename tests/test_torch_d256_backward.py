"""The loop backward (#4) past 128 columns: the plans, gates, launch sizes and
reductions of its tall and wide builds of widths up to 256
(``csrc/scann_loop_backward_{tall,wide}_d256.cu`` and their ``_bf16``
twins), on the CPU.

- Every plan fits a block's shared memory at every N up to 256 at D = 136,
  192 and 256, and the wide sub-chunk the Python plan names is the one
  ``build_plan`` of the CUDA source takes at that plan's atom block (the
  CUDA ``make_plan``'s sum, term by term, at 64 rows, else 32).
- The gate takes at least every M that the TPU's loop backward takes
  (``fits_loop_vmem(training=True)``) at D = 136 and 192 (256 is held in
  ``tests/test_torch_widths_train.py``).
- ``backward_cluster``: the largest of 8 ... 1 blocks per structure whose B
  clusters the card runs at once (the card's answers stubbed), past 128
  columns only.
- The weight-gradient, LayerNorm-partial and d(layer input) adds of the
  d256 builds are reductions (``red_add4`` / ``red_add``) under ``kD256``
  (``kLaneValues > 4``), beside the load-add-store of the builds up to 128.
"""

import dataclasses
import re

import pytest

from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.kernels import scann_loop as jax_loop
from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.kernels import _build
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from test_torch_widths import MP2018, QM9, RECIPE

WIDTHS = (136, 192, 256)
# clusters of 1-8 blocks an H100 SXM runs at once with a block on each SM
AT_ONCE = {8: 15, 7: 15, 6: 17, 5: 22, 4: 30, 3: 39, 2: 66, 1: 132}


def _at(cfm, D):
    return dataclasses.replace(cfm, local_dim=D, global_dim=D, dense_out=D)


def _cuda_wide_floats(cfm, M, N, block, rows):
    """``make_plan<true>(a, rows).total`` of ``csrc/scann_loop_backward.cu``."""
    r4 = lambda v: -(-v // 4) * 4
    D, G, O, H = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.num_head
    wd = max(D, G)
    lde = r4(cfm.embedding_dim + (10 if cfm.use_ring else 0))
    chunk = (rows * (2 * D + 4) + 3 * rows * (D + 4) + 2 * r4(N * H) + r4(rows * H) + wd)
    atoms = 5 * block * wd + r4(block)
    embed = block * 2 * lde + block * wd
    readout = block * wd + 4 * wd + 5 * r4(M) + 3 * r4(O) + 4
    return 5 * block * wd + max(chunk, atoms, embed, readout) + 8 * 2 * wd + 2 * wd


@pytest.mark.parametrize("D", WIDTHS)
def test_torch_d256_backward_plans_fit_every_n(D):
    """The tall and wide d256 plans of QM9 and MP2018 fit a block's 227 KB
    at every N up to 256, for small, recipe and tall structures."""
    for cfm in (_at(QM9, D), _at(MP2018, D)):
        for M in (8, 96, 322):
            for N in range(1, kfwd.MAX_NEIGHBORS + 1):
                lib = kloop.backward_library(cfm, M, N)
                assert lib.endswith("_d256"), (D, M, N, lib)
                chunk_atoms, block, nbytes = kloop.backward_plan(cfm, M, N)
                assert nbytes <= kloop.MAX_SHARED_BYTES, (D, M, N, block, nbytes)
                if kloop.is_wide_backward(cfm, N):
                    assert chunk_atoms == 1
                    assert kloop.wide_sub_chunk(cfm, M, N) in kloop.D256_WIDE_CHUNK_ROWS
                else:
                    assert chunk_atoms * N <= kloop.TALL_CHUNK_ROWS


@pytest.mark.parametrize("D", WIDTHS)
def test_torch_d256_wide_sub_chunk_is_the_cuda_build_plan(D):
    """At the Python plan's atom block, ``build_plan`` of the CUDA source
    takes 64 rows where ``make_plan`` at 64 fits 232,448 bytes, else 32: the
    rows ``wide_sub_chunk`` names, and the Python plan's bytes are that
    ``make_plan``'s, term by term."""
    for M in (24, 80, 322):
        for N in (33, 48, 64, 65, 80, 96, 97, 160, 256):
            cfm = _at(MP2018, D)
            _, block, nbytes = kloop.backward_plan(cfm, M, N)
            at64 = 4 * _cuda_wide_floats(cfm, M, N, block, 64)
            want = 64 if at64 <= kloop.MAX_SHARED_BYTES else 32
            rows = kloop.wide_sub_chunk(cfm, M, N)
            assert rows == want, (D, M, N, block)
            assert nbytes == 4 * _cuda_wide_floats(cfm, M, N, block, rows)
            if rows == 64:
                assert block >= 8


@pytest.mark.parametrize("D", [136, 192])
def test_torch_d256_backward_gate_against_the_tpu_kernel(D):
    """At D = G = O = 136 and 192 (256: ``tests/test_torch_widths_train.py``)
    the port's #4 takes every M that the TPU's loop backward takes
    (``fits_loop_vmem(training=True)``) at every N of QM9, MP2018 and
    Pt/graphene, and M into the thousands."""
    ptgp = ModelConfig(n_atoms=80, embedding_dim=48, n_attention=11, use_ring=True,
                       g_update=False, gaussian_d=4.0, **RECIPE)
    for cfm in (QM9, MP2018, ptgp):
        cfm = _at(cfm, D)
        jcfg = JaxModelConfig(**{f.name: getattr(cfm, f.name)
                                 for f in dataclasses.fields(JaxModelConfig)
                                 if hasattr(cfm, f.name)})
        for N in (8, 16, 32, 48, 96, 256):
            tpu = max([m for m in range(1, 512)
                       if jax_loop.fits_loop_vmem(jcfg, m, N, training=True)], default=0)
            assert kloop.backward_refusal(cfm, max(tpu, 1), N) is None, (cfm.n_atoms, N, tpu)
            assert kloop.backward_refusal(cfm, 1024, N) is None


@pytest.mark.parametrize("B,want", [(1, 8), (15, 8), (16, 6), (17, 6), (32, 3), (64, 2),
                                    (128, 1), (200, 1)])
def test_torch_d256_backward_cluster_fills_the_card(B, want, monkeypatch):
    """Past 128 columns a launch takes the largest of 8 ... 1 blocks per
    structure whose B clusters the card runs at once, asked of the
    launching build (``max_active_clusters``); up to 128 columns
    ``cluster_size(B)`` as before, without asking."""
    asked = []

    def at_once(cfm, B_, M_, N_, C, S=0):
        asked.append((kloop.backward_library(cfm, M_, N_, S), C))
        return AT_ONCE[C]

    monkeypatch.setattr(kloop, "max_active_clusters", at_once)
    for N in (32, 96):
        del asked[:]
        cfm = _at(MP2018, 256)
        assert kloop.backward_cluster(cfm, B, 96, N) == want
        assert {lib for lib, _ in asked} == {kloop.backward_library(cfm, 96, N)}
        assert asked[0][1] == 8 and asked[-1][1] == want
        del asked[:]
        narrow = _at(MP2018, 128)
        assert kloop.backward_cluster(narrow, B, 96, N) == kloop.cluster_size(B) and not asked


def test_torch_d256_backward_scratch_takes_the_rule(monkeypatch):
    """``loop_backward_scratch`` sizes its per-block rows by the launch's
    cluster (``backward_cluster`` when none is given): B * C gradient rows
    and tall slices."""
    import torch

    from scann_tpu_torch.models import init_params

    monkeypatch.setattr(kloop, "max_active_clusters", lambda cfm, B, M, N, C, S=0: AT_ONCE[C])
    cfm = dataclasses.replace(_at(MP2018, 256), n_attention=1)
    packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0)), cfm)
    for B, N, C in ((2, 32, 8), (16, 96, 6)):
        s = kloop.loop_backward_scratch(packed, cfm, B, 12, N, stash=None)
        assert s["rows"].shape[0] == B * C
        assert s["tall"].shape[0] == B * C
        assert (s["wide_rows"] is None) == (N <= 32)


def test_torch_d256_backward_reductions_in_the_sources():
    """The d256 builds add into the gradient rows, the LayerNorm partials and
    the d(layer input) partials by reductions, each under ``kD256`` (or
    ``kLaneValues > 4`` in the shared header), beside the load-add-store the
    builds up to 128 keep; their launcher takes up to 8 blocks a structure
    (the narrow builds 4)."""
    src = open(f"{_build.SRC_DIR}/scann_loop_backward.cu").read()
    mma = open(f"{_build.SRC_DIR}/scann_mma.cuh").read()
    assert "constexpr bool kD256 = kLaneValues > 4;" in src
    assert "constexpr int kMaxCluster = kLaneValues > 4 ? 8 : 4;" in src
    assert max(kloop.D256_CLUSTER_SIZES) == 8 and max(kloop.CLUSTER_SIZES) == 4
    assert "__device__ __forceinline__ void red_add4(float* dst, float4 v) {" in mma
    body = mma[mma.index("void mma_gemm_tA("):mma.index("// Energies and max-shifted softmax")]
    at = body.index("red_add4(")
    assert body.rfind("if constexpr (kLaneValues > 4) {", 0, at) >= 0
    assert "prev[q][mh] = __ldcg(" in body          # the builds up to 128
    kernel = src[src.index("void tall_scatter("):src.index("// The sizes make_plan reads")]
    calls = [m.start() for m in re.finditer(r"red_add4?\(", kernel)]
    assert len(calls) == 6
    for i in calls:
        assert kernel.rfind("if constexpr (kD256)", 0, i) > i - 600, kernel[i - 200:i]
    # the load-add-store the builds up to 128 keep, beside each
    for term in ("v[j] = idx[j] >= 0 ? dst[(size_t)idx[j] * ldd + d] : 0.f;",
                 "prev[mh] = __ldcg(reinterpret_cast<const float4*>(Gout + (size_t)i * ldg + jw));",
                 "gs[d] = accumulate ? gs[d] + s0 : s0;",
                 "else store4(p, make_float4(p[0] + v.x, p[1] + v.y, p[2] + v.z, p[3] + v.w));"):
        assert term in kernel, term
    assert kbwd.N_WARPS == 8
