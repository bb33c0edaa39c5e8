"""Widths above 128 (D, G, O up to 256) in the forwards #1, #3 and #5 of the
PyTorch port, against the JAX package on the CPU.

- The plain versions against the JAX kernels in interpret mode, on weights
  carried across from the flax parameters (``params_from_jax``) and seeded
  numpy inputs, at (D, G, O) = (136, 132, 140) (a width that does not
  divide 256) and (256, 256, 256), B = 2, M = 12, N = 6, L = 2, 8 heads:
  #1 (``fused_scann_forward``) and #3 (``loop_scann_forward``, also at a
  wide N = 40, which the wide build takes past 128 columns) at rtol 1e-5 /
  atol 1e-6, as ``tests/test_torch_loop.py``; #5 (``_pallas_forward``) at N
  = 8 and 72.
- The bf16 operand mode by the rules of the existing bf16 tests: #1 and #3
  at (136, 132, 140) by ``tests/test_torch_bf16_shapes.py``'s ``_hold`` over
  5 seeded batches (JAX's bf16 bound, rtol 0.05 / atol 0.02, on every
  output; each batch's mean gap to JAX in bf16 within the larger of 0.1 x
  JAX's own bf16-vs-f32 gap and 2 x the batch's f32-noise floor, and below
  the port's f32 result's; at D = 256 the f32 sums flip bfloat16 roundings
  so often that the floor reaches the gap); #5 at D = 256 by
  ``tests/test_torch_bf16.py``'s (JAX's bound and the pooled mean gap within
  0.1 x JAX's own gap).
- The whole model through ``Scann(cfg, device="cpu")`` (``load_params``,
  ``predict_featurized``) against the flax model's prediction of the same
  batch.
- Gates, plans and routes at D = G = O = 256: the kernel routes of the
  QM9 and MP2018 recipe buckets and of tall and wide crystals, a #5 plan at
  every N of the per-layer route, training on the loop backward (#2 keeps
  its limit of 128; ``tests/test_torch_widths_train.py`` holds #4's d256
  builds), D = 260 refused, the builds a
  launch takes (a stub in place of the CUDA library) and the plan terms
  read from the CUDA sources.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import jit_apply, jit_init_vars, make_synthetic_batch
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.kernels import local_attention as jla
from scann_tpu.kernels.scann_forward import fused_scann_forward as jax_fused_forward
from scann_tpu.kernels.scann_loop import loop_scann_forward as jax_loop_forward
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu_torch.api import Scann
from scann_tpu_torch.compat import params_from_jax
from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig
from scann_tpu_torch.data.structure import Structure
from scann_tpu_torch.kernels import _build
from scann_tpu_torch.kernels import local_attention as kla
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.kernels import widths
from scann_tpu_torch.models import init_params
from scann_tpu_torch.train import loop as train_loop
from test_kernels import make_layer_inputs
from test_torch_bf16_shapes import _f64, _hold, _jittered

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL, BF16_ATOL, GAP = 0.05, 0.02, 0.1
LAYER_BATCHES = 6    # seeded batches pooled into #5's bf16 gap (tests/test_torch_bf16.py)
SMALL = dict(n_atoms=10, embedding_dim=16, n_attention=2, num_head=8)
WIDTHS = {"136-132-140": dict(local_dim=136, global_dim=132, dense_out=140),
          "256": dict(local_dim=256, global_dim=256, dense_out=256)}
RECIPE = dict(num_head=8, scale=0.5, use_attn_norm=True, use_ga_norm=True,
              local_dim=256, global_dim=256, dense_out=256)
QM9 = ModelConfig(n_atoms=10, embedding_dim=48, n_attention=7, g_update=True, gaussian_d=4.0,
                  **RECIPE)
MP2018 = ModelConfig(n_atoms=95, embedding_dim=128, n_attention=9, g_update=True,
                     gaussian_d=6.0, **RECIPE)


def _torch(x):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}


def _setup(width, seed, M=12, N=6, dtype="float32", **kw):
    jcfg = JaxModelConfig(**SMALL, **WIDTHS[width], **kw)
    tcfg = ModelConfig(**SMALL, **WIDTHS[width], dtype=dtype, **kw)
    x = make_synthetic_batch(np.random.default_rng(seed), B=2, M=M, N=N)
    jp = jax.device_get(jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(seed), x))
    return jcfg, tcfg, jp, params_from_jax(jp, tcfg), x


# --- #1 and #3: the whole-model forwards ----------------------------------------------

@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("kernel", ["fused", "loop"])
def test_torch_widths_whole_model_plain_matches_jax_kernel(kernel, width):
    """#1's and #3's plain versions (the wrappers on CPU tensors) against
    the JAX kernels in interpret mode past 128 columns, where the port's
    gates take the shape and name the *_d256 build."""
    jcfg, tcfg, jp, tp, x = _setup(width, 31)
    if kernel == "fused":
        assert kfwd.refusal(tcfg, 12, 6) is None and kfwd.library(tcfg) == "scann_forward_d256"
        want = jax_fused_forward(jp, x, jcfg, interpret=True, batch_tile=1)
        with torch.no_grad():
            got = kfwd.fused_scann_forward(tp, _torch(x), tcfg)
    else:
        assert kloop.refusal(tcfg, 12, 6) is None
        assert kloop.forward_library(tcfg, 12, 6)[0] == "scann_loop_tall_d256"
        want = jax_loop_forward(jp, x, jcfg, interpret=True)
        with torch.no_grad():
            got = kloop.loop_scann_forward(tp, _torch(x), tcfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    assert kfwd.fused_scann_forward.d256_launches == kloop.launch_loop_forward.d256_launches == 0


@pytest.mark.parametrize("width", list(WIDTHS))
def test_torch_widths_loop_plain_at_wide_n_matches_jax_kernel(width):
    """#3's plain version against the JAX loop forward at N = 40, which past
    128 columns the wide build takes (two tall chunk buffers of 40 rows do
    not fit at D = 256)."""
    jcfg, tcfg, jp, tp, x = _setup(width, 32, M=10, N=40)
    assert kloop.is_wide_forward(tcfg, 40) and not kla.is_wide(40, kfwd.NARROW_WIDTH)
    assert kloop.forward_library(tcfg, 10, 40) == ("scann_loop_wide_d256",
                                                   "scann_loop_forward_wide_d256")
    want = jax_loop_forward(jp, x, jcfg, interpret=True)
    with torch.no_grad():
        got = kloop.loop_scann_forward(tp, _torch(x), tcfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def _assert_bf16(got, want, want_f32):
    """The rule of ``tests/test_torch_bf16.py``: every output within JAX's
    bf16 bound of JAX in bf16, and the pooled mean difference within GAP x
    JAX's own bf16-vs-f32 mean difference."""
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)
    flat = lambda arrays: np.concatenate([np.ravel(np.asarray(a, np.float32)) for a in arrays])
    g, w, w32 = flat(got), flat(want), flat(want_f32)
    port, rounding = np.abs(g - w).mean(), np.abs(w - w32).mean()
    assert rounding > 0
    assert port <= GAP * rounding, (port, rounding)


@pytest.mark.parametrize("kernel", ["fused", "loop"])
def test_torch_widths_bf16_plain_matches_jax_kernel(kernel):
    """#1's and #3's plain versions in the bf16 operand mode against the JAX
    kernels at model.dtype bfloat16 at (136, 132, 140), by ``_hold``'s
    statistics. At (256, 256, 256) these small batches' f32-noise floor
    reaches 0.3-1.2 x the bf16-vs-f32 gap, so the rule cannot tell the mode
    from f32 there (the port's f32 result reads 0.59 of its limit, median
    over 5 batches); the card holds the D = 256 builds in bf16 at full depth
    (``chip_smoke.py`` phase 20)."""
    width = "136-132-140"
    jk, port, extra = ((jax_fused_forward, kfwd.fused_scann_forward, {"batch_tile": 1})
                       if kernel == "fused" else (jax_loop_forward, kloop.loop_scann_forward, {}))
    fns = {}

    def run(seed):
        jcfg, tcfg, jp, tp, x = _setup(width, 40 + seed, dtype="bfloat16")
        for c in (dataclasses.replace(jcfg, dtype="bfloat16"), jcfg):
            fns.setdefault(c.dtype, jax.jit(lambda p, x, c=c: jk(p, x, c, interpret=True,
                                                                  **extra)))
        want = [fns["bfloat16"](jp, x), fns["float32"](jp, x),
                fns["bfloat16"](_jittered(jp, seed), x)]
        f32 = dataclasses.replace(tcfg, dtype="float32")
        with torch.no_grad():
            got = [port(q, _torch(x), c) for q, c in ((tp, tcfg), (_f64(tp), tcfg),
                                                      (_jittered(tp, seed), tcfg), (tp, f32))]
        for g, w in zip(got[0], want[0]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=BF16_RTOL, atol=BF16_ATOL)
        as_dict = lambda out: {"pred": np.asarray(out[0], np.float64),
                               "ga": np.asarray(out[1], np.float64)}
        return dict(zip(("p16", "p64", "pjit", "p32", "j16", "j32", "jjit"),
                        map(as_dict, got + want)))

    _hold(run, f"{kernel} bf16 {width}")


# --- #5: one LocalAttention layer ----------------------------------------------------

def _flat_params(params):
    return {f"{mod}/{name}": torch.from_numpy(np.asarray(v))
            for mod, leaves in params.items() for name, v in leaves.items()}


def _layer_inputs(rng, B, M, N, D, g_update=True):
    """``make_layer_inputs`` with its kernels at the scale of 1 / sqrt(fan
    in) they have at D = 32 (0.1 x a normal draw there), as the flax
    initializers scale them: at 0.1 the 768-term sums of D = 256 grow the
    layer's f32 rounding noise past atol 1e-6 on either side."""
    centers, idx, geometry, mask, weight, params = make_layer_inputs(
        rng, B=B, M=M, N=N, D=D, g_update=g_update)
    for leaves in params.values():
        if "kernel" in leaves:
            leaves["kernel"] = (leaves["kernel"] * np.sqrt(32 / D)).astype(np.float32)
    return centers, idx, geometry, mask, weight, params


@pytest.mark.parametrize("D,N", [(136, 8), (256, 8), (256, 72)])
@pytest.mark.parametrize("g_update", [True, False])
def test_torch_widths_layer_matches_jax_kernel(D, N, g_update):
    """#5's plain version (``fused_local_attention`` on CPU tensors) against
    the JAX per-layer kernel in interpret mode past 128 columns, at a
    narrow and a wide N."""
    rng = np.random.default_rng(D + N)
    centers, idx, geometry, mask, weight, params = _layer_inputs(rng, 2, 10, N, D, g_update)
    H, scale = 8, 0.5
    kla.check_supported(D, N, geometry.shape[-1], H, torch.float32)
    assert kla.library(N, D) == ("local_attention_wide_d256" if N > 64 else
                                 "local_attention_d256")
    want = jla._pallas_forward(*[jnp.asarray(a) for a in (centers, idx, geometry, mask, weight)],
                               params, H, scale, g_update, interpret=True)
    with torch.no_grad():
        out, geo, attn = kla.fused_local_attention(
            *[torch.from_numpy(a) for a in (centers, idx, geometry, mask, weight)],
            _flat_params(params), H, scale, g_update)
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want[2]), rtol=RTOL, atol=ATOL)
    if g_update:
        np.testing.assert_allclose(geo.numpy(), np.asarray(want[1]), rtol=RTOL, atol=ATOL)
    assert kla.fused_local_attention.launches == kla.fused_local_attention.d256_launches == 0


def test_torch_widths_layer_bf16_matches_jax_kernel():
    """#5's plain version on bfloat16 tensors (f32 inside, bfloat16 outputs)
    against ``_pallas_forward`` on the same bfloat16 inputs at D = 256, by
    the bf16 rule."""
    B, M, N, D, H = 2, 10, 8, 256, 8
    run = jax.jit(lambda c, i, g, m, p: jla._pallas_forward(c, i, g, m, None, p, H, 0.5, True,
                                                            interpret=True))
    got, want, want32 = [], [], []
    for seed in range(LAYER_BATCHES):
        centers, idx, geometry, mask, _, params = _layer_inputs(
            np.random.default_rng(50 + seed), B, M, N, D)

        def jax_run(dtype):
            j = lambda a: jnp.asarray(np.asarray(a, np.float32)).astype(dtype)
            return run(j(centers), jnp.asarray(idx), j(geometry), j(mask),
                       jax.tree.map(j, params))

        bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
        with torch.no_grad():
            out, geo, attn = kla.fused_local_attention(
                bf(centers), torch.from_numpy(idx), bf(geometry), bf(mask), None,
                {k: v.to(torch.bfloat16) for k, v in _flat_params(params).items()}, H, 0.5,
                True)
        j16, j32 = jax_run(jnp.bfloat16), jax_run(jnp.float32)
        got += [t.float().numpy() for t in (out, attn, geo)]
        want += [np.asarray(t, np.float32) for t in (j16[0], j16[2], j16[1])]
        want32 += [np.asarray(t) for t in (j32[0], j32[2], j32[1])]
    _assert_bf16(got, want, want32)


# --- the whole model through the entry point -----------------------------------------

def test_torch_widths_scann_predicts_as_the_flax_model():
    """``Scann(cfg, device="cpu")`` of a model at (136, 132, 140), with the
    flax model's weights (``load_params``), predicts a batch of two
    structures through ``predict_featurized`` (the eval route "fused", #1's
    plain version) as the flax model does: the un-standardized property and
    the GA scores of each structure's atoms."""
    jcfg, tcfg, jp, _, x = _setup("136-132-140", 33)
    want = jit_apply(JaxScannModel(config=jcfg))(jp, x)
    hyper = HyperConfig(target_mean=-0.2, target_std=0.03)
    ts = Scann(ScannConfig(model=tcfg, hyper=hyper), device="cpu")
    ts.load_params(jp)
    assert ts.trainer.eval_route(12, 6) == "fused"
    counts = x["atom_mask"][:, :, 0].sum(1).astype(int)
    rng = np.random.default_rng(33)
    structs = [Structure(["C"] * n, rng.uniform(0, 5, size=(n, 3))) for n in counts]
    got = ts.predict_featurized(structs, [{k: v[b:b + 1] for k, v in x.items()}
                                          for b in range(2)])
    for b, (value, ga) in enumerate(got):
        prop = np.asarray(want["property"])[b, 0] * hyper.target_std + hyper.target_mean
        np.testing.assert_allclose(np.float32(value), np.float32(prop), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ga, np.asarray(want["ga_score"])[b, :counts[b], 0],
                                   rtol=RTOL, atol=ATOL)


# --- gates, plans and routes at D = G = O = 256 ------------------------------------------

def _trainer(cfm):
    return train_loop.Trainer(ScannConfig(model=cfm), device="cpu")


@pytest.mark.parametrize("cfm,M,N,route,library", [
    (QM9, 32, 16, "fused", "scann_forward_d256"),
    (MP2018, 96, 32, "loop", "scann_loop_tall_d256"),
    (MP2018, 80, 96, "loop", "scann_loop_wide_d256"),
    (MP2018, 322, 32, "loop", "scann_loop_tall_d256"),
    (MP2018, 64, 64, "loop", "scann_loop_wide_d256"),
    (QM9, 64, 16, "loop", "scann_loop_tall_d256"),
])
def test_torch_widths_eval_routes_take_a_kernel(cfm, M, N, route, library):
    """At D = G = O = 256 the recipe buckets and the tall and wide crystals
    evaluate on a whole-model kernel, each in its *_d256 build, which the
    Trainer builds before a fit or a served ladder (``shape_libraries``);
    they train on the loop backward's d256 builds
    (``tests/test_torch_widths_train.py``)."""
    trainer = _trainer(cfm)
    assert trainer.eval_route(M, N) == route
    assert trainer.train_route(M, N) == "loop"
    assert trainer.shape_libraries([(M, N, 0)]) == (library,)
    assert library in _build.WIDTH_SOURCES and library in _build.SHAPE_SOURCES
    if route == "loop":
        assert kloop.forward_library(cfm, M, N)[0] == library


def test_torch_widths_qm9_takes_32_row_chunks():
    """#1 at the QM9 bucket (32, 16) and D = 256 takes chunks of 32 rows (2
    atoms): 203,424 bytes, the 64-row plan's 303,776 past a block; at D =
    128 the plan keeps its 64-row chunks."""
    assert kfwd.shared_memory_plan(QM9, 32, 16) == (2, 25088, 203424)
    ldm = 260
    assert 4 * (3 * 32 * ldm + kfwd.forward_chunk_floats(64, 256, 8) + 2 * ldm + 32 + 256) == 303776
    narrow = dataclasses.replace(QM9, local_dim=128, global_dim=128, dense_out=128)
    assert kfwd.shared_memory_plan(narrow, 32, 16)[0] == 4
    assert kfwd.refusal(QM9, 64, 64) is not None          # N = 64 goes on to #3
    assert kloop.refusal(QM9, 64, 64) is None


@pytest.mark.parametrize("N", [8, 32, 64, 96, 256])
@pytest.mark.parametrize("bf16", [False, True])
def test_torch_widths_per_layer_route_has_a_plan(N, bf16):
    """The per-layer route of a D = 256 model without the attention
    LayerNorm has a #5 plan at every N (narrow blocks down to 8 atoms, the
    wide build's down to 1), at small and recipe batches, SCANN+ and SCANN."""
    cfm = dataclasses.replace(MP2018, use_attn_norm=False)
    assert _trainer(cfm).eval_route(96, N) == "per_layer"
    for B, M in ((1, 48), (8, 96), (64, 96)):
        for g_update in (True, False):
            ab, ca, nbytes = kla.make_plan(B, M, N, 256, 8, g_update, 132, bf16)
            assert ab in (kla.WIDE_ATOM_BLOCKS if kla.is_wide(N, 256)
                          else widths.class_of(256).atom_blocks)
            assert nbytes <= kla.MAX_SHARED_BYTES and ca >= 1


def test_torch_widths_backward_gates_keep_128():
    """The molecule backward #2 keeps its limit of 128 columns (4 values of
    a row a lane and seven resident [M, max(D, G)] buffers): its gate names
    the width and the loop backward; the loop backward #4 takes widths up to
    512 in its d256 and d512 builds (``kloop.BACKWARD_MAX_WIDTH``, as the
    forwards' ``kfwd.MAX_WIDTH``), so a D = 256 QM9 model trains its recipe
    bucket (32, 16) on "loop", D = 260 is refused by #2 and trains on "loop"
    too, and D = 516 is refused by both and trains on "per_layer", while
    the forwards evaluate D = 260 on #3."""
    assert kbwd.MAX_WIDTH == 128 and kloop.BACKWARD_MAX_WIDTH == 512
    assert kfwd.MAX_WIDTH == 512
    reason = kbwd.refusal(QM9, 32, 16)
    assert reason is not None and "<= 128" in reason and "D=256" in reason
    assert "loop_scann_train_grads" in reason
    assert kloop.backward_refusal(MP2018, 96, 32) is None
    assert kloop.backward_refusal(QM9, 32, 16) is None
    assert _trainer(QM9).train_route(32, 16) == "loop"
    narrow = dataclasses.replace(QM9, local_dim=128, global_dim=128, dense_out=128)
    assert _trainer(narrow).train_route(32, 16) == "fused"
    wide = dataclasses.replace(MP2018, local_dim=260, num_head=4)
    assert kloop.backward_refusal(wide, 96, 32) is None
    assert kbwd.refusal(wide, 32, 16) is not None
    assert _trainer(wide).train_route(96, 32) == "loop"
    assert _trainer(wide).eval_route(96, 32) == "loop"
    wider = dataclasses.replace(MP2018, local_dim=516, num_head=4)
    reason = kloop.backward_refusal(wider, 96, 32)
    assert reason is not None and "<= 512" in reason and "D=516" in reason
    assert _trainer(wider).train_route(96, 32) == "per_layer"


def test_torch_widths_past_256_are_refused():
    """Past 512 columns every forward's gate refuses, with the gate's message
    (D = 516, 4 heads: the width is the only reason), and the per-layer
    route's #5 raises the same; D = 260 is taken by the forwards' builds
    past 256 (``tests/test_torch_d512.py``)."""
    wide = dataclasses.replace(MP2018, local_dim=516, num_head=4)
    for reason in (kfwd.refusal(wide, 32, 16), kloop.refusal(wide, 96, 32)):
        assert reason is not None and "<= 512" in reason and "D=516" in reason
    with pytest.raises(NotImplementedError, match="<= 512"):
        kla.check_supported(516, 32, 20, 4, torch.float32)
    assert _trainer(wide).eval_route(96, 32) == "per_layer"
    taken = dataclasses.replace(MP2018, local_dim=260, num_head=4)
    assert kloop.refusal(taken, 96, 32) is None and kfwd.refusal(taken, 32, 16) is None
    kla.check_supported(260, 32, 20, 4, torch.float32)


@pytest.mark.parametrize("route", ["fused", "tall", "wide", "layer", "layer wide"])
def test_torch_widths_launch_the_d256_builds(route, monkeypatch):
    """The launch wrappers hand a D = 256 batch to the *_d256 library with
    their own plan (a stub in place of the CUDA library) and count it."""
    seen = []
    monkeypatch.setattr(kfwd, "call_kernel", lambda *a, **k: seen.append(a))
    monkeypatch.setattr(kloop, "max_active_forward_clusters", lambda *a, **k: 132)
    monkeypatch.setattr(kfwd, "max_active_clusters", lambda *a, **k: 132)
    monkeypatch.setattr(kla, "sm_count", lambda dev: 132)
    cfm = dataclasses.replace(MP2018, n_attention=1)
    if route in ("fused", "tall", "wide"):
        M, N = {"fused": (12, 6), "tall": (40, 16), "wide": (10, 48)}[route]
        x = _torch(make_synthetic_batch(np.random.default_rng(0), B=2, M=M, N=N, n_atoms=95))
        packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0)), cfm)
        if route == "fused":
            kfwd._launch(packed, x, cfm, False)
            want = ("scann_forward_d256", "scann_forward_d256")
            counter = kfwd.fused_scann_forward
        else:
            kloop._launch(packed, x, cfm, False)
            want = kloop.forward_library(cfm, M, N)
            assert want[0] == f"scann_loop_{route}_d256"
            counter = kloop.launch_loop_forward
            chunk_atoms, block, work, _ = kloop.forward_plan(cfm, M, N)
            assert seen[0][4][16:18] == [chunk_atoms, work] and seen[0][4][20] == block
    else:
        N = 96 if route == "layer wide" else 32
        rng = np.random.default_rng(1)
        c, i, g, m, w, p = make_layer_inputs(rng, B=2, M=10, N=N, D=256)
        kla._launch(*[torch.from_numpy(a) for a in (c, i, g, m, w)], _flat_params(p), 8, 0.5,
                    True)
        want = (kla.library(N, 256),) * 2
        counter = kla.fused_local_attention
        assert seen[0][4][8:] == list(kla.make_plan(2, 10, N, 256, 8, True, 132))
    assert seen[0][:2] == want
    assert counter.launches == counter.d256_launches == 1
    for c in (kfwd.fused_scann_forward, kloop.launch_loop_forward, kla.fused_local_attention):
        for name in ("launches", "bf16_launches", "wide_launches", "tall_launches",
                     "d256_launches"):
            if hasattr(c, name):
                setattr(c, name, 0)


def _source(name):
    with open(f"{_build.SRC_DIR}/{name}") as f:
        return f.read()


def test_torch_widths_plans_match_cuda_sources():
    """The Python mirrors against the CUDA sources past 128 columns: the
    lane values and width limit, the *_d256 sources' defines, the narrow
    #5's atom blocks, the loop forward's tall limit, and each launcher's
    width check."""
    common = _source("scann_common.cuh")
    assert re.search(r"#if defined\(SCANN_WIDTH_512\)\nconstexpr int kLaneValues = 16;\n"
                     r"#elif defined\(SCANN_WIDTH_256\)\nconstexpr int kLaneValues = 8;\n#else\n"
                     r"constexpr int kLaneValues = 4;\n#endif\nconstexpr int kMaxWidth = "
                     r"32 \* kLaneValues;", common)
    assert 32 * 16 == kfwd.MAX_WIDTH == kla.MAX_WIDTH and 32 * 4 == kfwd.NARROW_WIDTH
    assert tuple(c.width for c in widths.CLASSES) == (32 * 4, 32 * 8, 32 * 16)
    for width in ("256", "512"):
        for name, base, defines in (
                (f"scann_forward_d{width}", "scann_forward.cu", ()),
                (f"scann_loop_tall_d{width}", "scann_loop.cu", ("SCANN_LOOP_TALL",)),
                (f"scann_loop_wide_d{width}", "scann_loop.cu", ("SCANN_LOOP_WIDE",)),
                (f"local_attention_d{width}", "local_attention.cu", ()),
                (f"local_attention_wide_d{width}", "local_attention.cu",
                 ("SCANN_LOCAL_ATTENTION_WIDE",))):
            src = _source(f"{name}.cu")
            assert "#define SCANN_WIDTH_256\n" in src and f'#include "{base}"' in src
            assert ("#define SCANN_WIDTH_512\n" in src) == (width == "512")
            assert all(f"#define {d}\n" in src for d in defines)
            assert _build.source_files(name)[1].endswith(base)
    assert set(_build.WIDTH_SOURCES) == {"scann_forward_d256", "scann_loop_tall_d256",
                                         "scann_loop_wide_d256", "local_attention_d256",
                                         "local_attention_wide_d256",
                                         "scann_loop_backward_tall_d256",
                                         "scann_loop_backward_wide_d256",
                                         "scann_loop_backward_tall_d256_bf16",
                                         "scann_loop_backward_wide_d256_bf16",
                                         "scann_forward_d512", "scann_loop_tall_d512",
                                         "scann_loop_wide_d512", "local_attention_d512",
                                         "local_attention_wide_d512",
                                         "scann_loop_backward_tall_d512",
                                         "scann_loop_backward_wide_d512",
                                         "scann_loop_backward_tall_d512_bf16",
                                         "scann_loop_backward_wide_d512_bf16"}
    la = _source("local_attention.cu")
    assert ("#if defined(SCANN_WIDTH_512)\nconstexpr int kAtomBlocks[] = {64, 48, 32, 16, 8, 4};"
            "\n#elif defined(SCANN_WIDTH_256)\nconstexpr int kAtomBlocks[] = {64, 48, 32, 16, 8};"
            "\n#else\nconstexpr int kAtomBlocks[] = {64, 48, 32, 16};\n#endif") in la
    assert [c.atom_blocks for c in widths.CLASSES] == [
        (64, 48, 32, 16), (64, 48, 32, 16, 8), (64, 48, 32, 16, 8, 4)]
    assert kla.ATOM_BLOCKS == widths.class_of(128).atom_blocks
    assert "a.D < 4 || a.D > kMaxWidth ||" in la
    assert "local_attention_wide_d256_##x" in la and "local_attention_d256_##x" in la
    assert "local_attention_wide_d512_##x" in la and "local_attention_d512_##x" in la
    loop = _source("scann_loop.cu")
    assert ("constexpr int kTallMaxN = kLaneValues > 8 ? 16 : kLaneValues > 4 ? 32 : "
            "kFwdMaxChunkRows;") in loop
    assert [c.tall_max_n for c in widths.CLASSES] == [kloop.MAX_CHUNK_ROWS, 32, 16]
    assert kloop.MAX_CHUNK_ROWS == 64
    assert "if ((a.N > kTallMaxN) != kWideBuild ||" in loop
    assert "a.D > kMaxWidth || a.G > kMaxWidth || a.O > kMaxWidth ||" in loop
    assert "scann_loop_forward_tall_d256_##x" in loop and "scann_loop_forward_wide_d256_##x" in loop
    assert "scann_loop_forward_tall_d512_##x" in loop and "scann_loop_forward_wide_d512_##x" in loop
    fwd = _source("scann_forward.cu")
    assert "a.D > kMaxWidth || a.G > kMaxWidth ||\n      a.O > kMaxWidth" in fwd
    assert "scann_forward_d256_##x" in fwd and "scann_forward_d512_##x" in fwd
    # the wide atom's context past 128 columns: one thread a column over all N
    walk = _source("scann_forward_common.cuh")
    assert "if constexpr (kLaneValues > 4) {" in walk
    assert "for (int n = 0; n < N; ++n) s += e[n * H] * keys[n * ldk + tid];" in walk


@pytest.mark.parametrize("D,N,want", [
    (256, 16, (2, 16)), (256, 32, (1, 16)), (136, 32, (2, 32)), (256, 8, (4, 16))])
def test_torch_widths_tall_plan_takes_32_row_chunks(D, N, want):
    """The tall #3's plan past 128 columns: the first of 64, 32 and 16 rows
    whose plan fits (two operand buffers beside the slots), counted here
    term by term as ``l2_plan`` of ``csrc/scann_loop.cu`` lays it out."""
    cfm = dataclasses.replace(MP2018, local_dim=D, global_dim=D, dense_out=D)
    chunk_atoms, block, work, nbytes, keys = kloop.l2_memory_plan(cfm, 322, N)
    assert (chunk_atoms, block) == want and not keys
    rows, wd = chunk_atoms * N, D
    front = max(rows * (D + 4) + -(-rows * 8 // 4) * 4, block * (wd + 4))
    chunk = front + 2 * rows * (2 * D + 4) + -(-2 * rows // 4) * 4 + 4
    assert work == max(chunk, block * wd + 2 * wd + 2 * 324 + D)
    assert nbytes == 4 * (2 * block * (wd + 4) + work) <= kloop.MAX_SHARED_BYTES
    assert rows <= 32 or D < 256
