"""Tall structures in the PyTorch port (kernels #3 and #4 at a narrow N with M
past the narrow builds' shared-memory plans: the centers in global memory)
against the JAX package on the CPU, in float32.

- The plans and gates: the tall plans drop the resident [M, max(D, G)]
  buffer, so they do not grow with M apart from the readout's vectors, and
  take atom blocks of 32 again; ``forward_library`` / ``backward_library``
  name the tall build past the narrow plan and only there (``tall=True``
  forces it), the wide build at a wide N.
- The scratch of each build (``loop_forward_scratch``,
  ``loop_backward_scratch``), a kept scratch of another build refused, and
  the launch arguments with a stub in place of the CUDA library.
- The CUDA sources: the narrow and wide builds take ``kTall = false``, the
  two tall sources define it, and the plans' terms.
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

@pytest.mark.parametrize("N", [8, 16, 24, 32, 48, 64])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_torch_tall_plans_do_not_grow_with_m(name, N):
    """Past the narrow plans, the tall plans take atom blocks of 32 and the
    same bytes at every M up to thousands of atoms: only the readout's
    vectors (2 [M] in #3, 5 in #4) grow, and they take over the work region
    only where they outgrow a chunk's buffers."""
    cfm = CONFIGS[name]
    wd, O = 128, cfm.dense_out
    fwd = [kloop.loop_memory_plan(cfm, M, N, tall=True) for M in (240, 600, 1000, 4000)]
    assert len({p for p in fwd}) == 1 and fwd[0][1] == 32
    chunk_atoms, block, work, nbytes = fwd[0]
    assert nbytes == 4 * (2 * 32 * (wd + 4) + work)
    big = 16000       # the readout's [AB, wd] block and vectors outgrow a chunk's buffers
    assert kloop.loop_memory_plan(cfm, big, N, tall=True) == (
        chunk_atoms, 32, 32 * wd + 2 * wd + 2 * r4(big) + r4(O),
        4 * (2 * 32 * (wd + 4) + 32 * wd + 2 * wd + 2 * r4(big) + r4(O)))
    if N > kbwd.MAX_CHUNK_ROWS:
        return
    bwd = [kloop.loop_backward_memory_plan(cfm, M, N, tall=True) for M in (240, 600, 1000, 3000)]
    assert len({p for p in bwd}) == 1 and bwd[0][1] == 32
    rest = 5 * 32 * wd + kbwd.N_WARPS * 2 * wd + 2 * wd
    assert bwd[0][2] - 4 * rest == 4 * max(kbwd.chunk_floats(bwd[0][0] * N, 128, 8),
                                           5 * 32 * wd + 32, 32 * wd + 4 * wd + 5 * r4(3000)
                                           + 3 * r4(O) + 4,
                                           32 * (2 * r4(cfm.embedding_dim
                                                        + (10 if cfm.use_ring else 0)))
                                           + 32 * wd)
    big = 6000
    assert kloop.loop_backward_memory_plan(cfm, big, N, tall=True)[2] == 4 * (
        rest + 32 * wd + 4 * wd + 5 * r4(big) + 3 * r4(O) + 4)
    # the narrow plans hold M * 512 bytes more at one atom block
    for M in (96, 200):
        narrow = kloop.loop_backward_memory_plan(cfm, M, N)
        tall = kloop.loop_backward_memory_plan(cfm, M, N, tall=True)
        if narrow[1] == 32:
            assert narrow[2] - tall[2] == 4 * M * wd


@pytest.mark.parametrize("N", [8, 16, 24, 32, 48, 64, 96])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_torch_tall_builds_only_past_the_narrow_plan(name, N):
    """``forward_library`` and ``backward_library`` name the tall build one
    atom past the narrow plan's edge and not at it; a wide N takes the wide
    build at any M; ``tall=True`` forces the tall build at a narrow N and
    the gate's plan (``forward_plan``, ``backward_plan``) stays the narrow
    one there."""
    cfm = CONFIGS[name]
    edge3 = _narrow_edge(lambda M: kloop.loop_memory_plan(cfm, M, N)[3])
    if kloop.is_wide(N):
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
    if kloop.is_wide_backward(N):
        assert kloop.backward_library(cfm, edge4 + 1, N, tall=True) == "scann_loop_backward_wide"
        assert not kloop.is_tall_backward(cfm, edge4 + 1, N)
    else:
        assert kloop.backward_library(cfm, edge4, N) == "scann_loop_backward"
        assert kloop.backward_library(cfm, edge4 + 1, N) == "scann_loop_backward_tall"
        assert kloop.backward_library(cfm, 96, N, tall=True) == "scann_loop_backward_tall"
        assert kloop.backward_plan(cfm, edge4, N) == kloop.loop_backward_memory_plan(
            cfm, edge4, N)
        assert kloop.backward_refusal(cfm, edge4 + 1, N) is None
        assert kloop.backward_refusal(cfm, 968, N) is None
    # bf16 operands: the same builds at the same edges, #4's in their bf16 sources
    b16 = dataclasses.replace(cfm, dtype="bfloat16")
    if not kloop.is_wide_backward(N):
        assert kloop.backward_library(b16, edge4, N) == "scann_loop_backward_bf16"
        assert kloop.backward_library(b16, edge4 + 1, N) == "scann_loop_backward_tall_bf16"
        assert kloop.backward_library(b16, 96, N, tall=True) == "scann_loop_backward_tall_bf16"
        assert kloop.backward_refusal(b16, edge4 + 1, N) is None
        assert kloop.backward_plan(b16, edge4 + 1, N) == kloop.backward_plan(cfm, edge4 + 1, N)
    else:
        assert kloop.backward_library(b16, edge4 + 1, N) == "scann_loop_backward_wide_bf16"
    if not kloop.is_wide(N):
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
    ping-pong [2, B, M, D] tall beside the GA keys [B * C, M, G]; #4's tall
    scratch [B * C, M, G + D] (GA keys, then the d(layer input) partial),
    None in the narrow and wide builds."""
    cfm = dataclasses.replace(MP2018, global_dim=64)
    B, N, D, G = 3, 16, 128, 64
    packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0), "cpu"), cfm)
    for M, C, tall in ((96, 4, False), (300, 4, True), (300, 2, True), (96, 1, True)):
        assert kloop.is_tall(cfm, M, N) == (M > 200)
        f = kloop.loop_forward_scratch(cfm, B, M, N, "cpu", C, tall=tall if M < 200 else None)
        assert tuple(f["next_centers"].shape) == ((2, B, M, D) if tall else (B, M, D))
        assert (f["tall"] is None) != tall and f["wide_keys"] is None
        if tall:
            assert tuple(f["tall"].shape) == (B * C, M, G)
        s = kloop.loop_backward_scratch(packed, cfm, B, M, N, C, None,
                                        tall=tall if M < 200 else None)
        assert (s["tall"] is None) != tall and s["wide_keys"] is None
        if tall:
            assert tuple(s["tall"].shape) == (B * C, M, G + D)
        assert tuple(s["dcenters"].shape) == (B, M, D) and s["rows"].shape[0] == B * C
    wide = kloop.loop_backward_scratch(packed, cfm, B, 96, 48, 2, None)
    assert wide["tall"] is None and wide["wide_keys"] is not None


@pytest.mark.parametrize("M,force", [(96, False), (96, True), (300, False)])
def test_torch_tall_launch_arguments(M, force, monkeypatch):
    """A tall launch (past the narrow plan, or ``tall=True``) calls the tall
    builds with the tall scratch in the last pointer slot, the ping-pong
    centers in #3's slot 49, the gate's plan (the narrow one where it fits,
    so a forced launch runs the narrow atom blocks) and counts
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
    for keys, cols in ((t_f[-1], 128), (t_b[-1], 256)):
        assert (keys is None) != tall
        if tall:
            assert tuple(keys.shape) == (B * 2, M, cols) and keys.dtype == torch.float32
    assert (d_f[16], d_f[20], d_f[17]) == tuple(kloop.forward_plan(cfm, M, N)[:3])
    assert d_b[21] == kloop.backward_plan(cfm, M, N)[1]
    if force:     # the narrow plan's atom blocks, not the tall plan's
        assert d_f[20] == kloop.loop_memory_plan(cfm, M, N)[1]
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
    assert "p.offQ = kTall ? 0 : a.M * p.wd;" in src["scann_loop"]
    assert "p.offBlk = kTall ? 0 : a.M * p.wd;" in src["scann_loop_backward"]
    # the tall builds take both operand modes and want their scratch
    assert "(kTall && bf16)" not in src["scann_loop"]
    assert "(wide_keys != nullptr) != (kWideBuild || kTall)" in src["scann_loop"]
    assert "(wide_keys != nullptr) != (kWide || kTall)" in src["scann_loop_backward"]
    # the gather of the tall #3 reads past L1
    with open(f"{_build.SRC_DIR}/scann_forward_common.cuh") as f:
        assert "v[j] = kL2 ? __ldcg(src) : *src;" in f.read()


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
