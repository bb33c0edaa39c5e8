"""``model.dtype: bfloat16`` at the wide and tall shapes of the PyTorch port's
crystal loop kernels (#3 and #4) against the JAX package on the CPU.

- The plain versions of #3 and #4 in the bf16 operand mode
  (``loop_scann_forward`` / ``loop_scann_train_grads`` on CPU tensors at
  ``model.dtype: bfloat16``) against the JAX loop kernels at a bf16 config
  in interpret mode: at wide N (B = 2, M = 12, N = 40 and 72, L = 2, D = 32,
  SCANN+ and SCANN with ring features, the masked edges of
  ``test_torch_wide._masked_edges``; #4 at dropout 0.1 with attention
  dropout, on the JAX kernel's own masks) and at the tall shape (B = 1, M =
  240, N = 8, one layer at D = G = 128, where the narrow plans stop below
  240 atoms). The statistics are ``test_torch_bf16_train._hold``'s, over 5
  seeded batches of a shape (``_hold`` here): the cosine with JAX's f32
  result, the pooled mean difference from JAX's bf16 result below the one
  the port's f32 result reads, the forward's outputs and #4's pred within
  rtol 0.05 / atol 0.02 of JAX's bf16 outputs, and the median over the
  batches of the mean absolute difference from JAX's bf16 result as a share
  of its limit at most 1. The limit of a batch is the larger of 0.1 x JAX's
  own bf16-vs-f32 mean difference (``_hold``'s) and 2 x the batch's
  f32-noise floor (chip_smoke's phases 14-15 criterion): how far f32
  sum-order noise alone moves a bf16 result of that batch, the largest of
  the port's distance from itself with f64 arithmetic between the same
  bfloat16 roundings and on weights moved by 1e-7 of their size, and JAX's
  from itself on such weights. At these sizes the f32 sums straddle a
  bfloat16 rounding boundary in most batches and one flip moves everything
  downstream: at the tall SCANN+ forward JAX's kernel reads 0.002-0.58 x
  its own gap against itself on moved weights (median 0.14, above 0.1), and
  the port's f32 version 0.005-2.02 x against its f64 version. So the
  median must also stay below half the one the port's f32 result reads
  against the same limits (what a port that skipped the mode reads,
  chip_smoke's 0.5 x with one layer): 0.91 at that shape, 1.4-10 at the
  others.
- The gates of the bf16 operand mode are the f32 gates (the shared-memory
  plans do not depend on the mode, as ``fits_loop_vmem`` on the TPU does
  not): the same refusals, plans, builds and Trainer routes at every N from
  8 to 256 for the QM9, MP2018 and Pt/graphene widths.
- The builds a bf16 launch takes (``forward_library``, ``backward_library``,
  ``Trainer.shape_libraries``), the launch arguments with a stub in place of
  the CUDA library, and the CUDA sources' bf16 instantiations.
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
from scann_tpu_torch.config import ModelConfig, ScannConfig
from scann_tpu_torch.kernels import _build
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.models import init_params
from scann_tpu_torch.train import loop as train_loop
from test_torch_bf16_train import ATOL, BATCHES, COSINE, GAP, RTOL, _flat
from test_torch_stash import _interpreted, _jax_masks
from test_torch_tall import CONFIGS
from test_torch_wide import SMALL, _stub, _wide_batch

torch.set_num_threads(1)

CASES = {"scann+": dict(g_update=True), "scann ring": dict(g_update=False, use_ring=True)}
# (B, M, N, widths) of each shape: wide N at the small widths, the tall shape
# with one layer at the kernels' full width
FLOOR = 2.0    # x the f32-noise floor, where that is above GAP's share (chip_smoke's BF16_FLOOR)
SKIP = 0.5     # of the f32 result's reading against the same limits
SHAPES = {
    "wide 40": (2, 12, 40, SMALL),
    "wide 72": (2, 12, 72, SMALL),
    "tall": (1, 240, 8, dict(SMALL, n_attention=1, local_dim=128, num_head=8, global_dim=128)),
}


def _hold(run, label):
    """``run(seed)`` -> the results of one seeded batch, a dict: the port's
    bf16 plain version ``p16``, the same with f64 arithmetic ``p64`` and on
    jittered weights ``pjit``, the port's f32 plain version ``p32``, JAX in
    bf16 ``j16``, on jittered weights ``jjit``, and in f32 ``j32``; the holds
    of the module docstring over ``BATCHES`` batches. Returns the per-batch
    ratios of the port's distance to its limit."""
    ratios, share, floors, skipped, port_sum, skip_sum = [], [], [], [], 0.0, 0.0
    cos = lambda a, b: a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    dist = lambda a, b: np.abs(a - b).mean()
    for seed in range(BATCHES):
        r = {k: _flat(v) for k, v in run(seed).items()}
        p16, j16, j32 = r["p16"], r["j16"], r["j32"]
        assert len({v.shape for v in r.values()}) == 1 and np.isfinite(p16).all()
        gap = dist(j16, j32)
        mine, own = cos(p16, j32), cos(j16, j32)
        assert gap > 0 and mine > min(COSINE, own - 1e-4), (seed, mine, own)
        floor = max(dist(r["p64"], p16), dist(r["pjit"], p16), dist(r["jjit"], j16)) / gap
        share.append(dist(p16, j16) / gap)
        floors.append(floor)
        ratios.append(share[-1] / max(GAP, FLOOR * floor))
        skipped.append(dist(r["p32"], j16) / gap / max(GAP, FLOOR * floor))
        port_sum += dist(p16, j16)
        skip_sum += dist(r["p32"], j16)
    rnd = lambda v: np.round(v, 4).tolist()
    print(f"{label}: mean |port bf16 - JAX bf16| / JAX's bf16-vs-f32 gap per batch "
          f"{rnd(share)} (median {np.median(share):.4f}); f32-noise floor {rnd(floors)}; "
          f"of the limit {rnd(ratios)} (median {np.median(ratios):.4f}; the port's f32 result "
          f"{rnd(skipped)}, median {np.median(skipped):.4f}); pooled "
          f"{port_sum / skip_sum:.4f} x the port's f32 result's distance")
    assert np.median(ratios) <= 1.0, ratios
    assert np.median(ratios) <= SKIP * np.median(skipped), (ratios, skipped)
    assert port_sum < skip_sum, (port_sum, skip_sum)
    return ratios


def _jittered(params, seed):
    """The port's params (a dict of tensors) or JAX's (a tree of arrays),
    each times 1 + 1e-7 x a seeded normal draw: about one f32 ulp."""
    rng = np.random.default_rng(seed)
    if isinstance(params, dict) and all(isinstance(v, torch.Tensor) for v in params.values()):
        return {k: v * torch.from_numpy(1 + 1e-7 * rng.normal(size=tuple(v.shape))).float()
                for k, v in sorted(params.items())}
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) * (1 + 1e-7 * rng.normal(size=np.shape(v)))).astype(np.float32),
        params)


def _f64(params):
    return {k: v.double() for k, v in params.items()}


def _setup(seed, shape, dropout, **kw):
    """(JAX f32 and bf16 configs, the port's bf16 and f32 configs, JAX params,
    the port's params, numpy inputs, torch inputs) of one seeded batch."""
    B, M, N, widths = SHAPES[shape]
    jcfg = JaxModelConfig(**widths, use_drop=dropout, **kw)
    tcfg = ModelConfig(**widths, use_drop=dropout, dtype="bfloat16", **kw)
    x = _wide_batch(np.random.default_rng(seed), B, M, N, tcfg.use_ring)
    jparams = jax.device_get(jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(seed),
                                           x))
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    return (jcfg, dataclasses.replace(jcfg, dtype="bfloat16"), tcfg,
            dataclasses.replace(tcfg, dtype="float32"), jparams,
            params_from_jax(jparams, tcfg), x, tx)


def _check_shape(shape, tcfg, training):
    """The shape takes the build this file is about, in the bf16 mode."""
    _, M, N, _ = SHAPES[shape]
    if training:
        assert kloop.backward_refusal(tcfg, M, N) is None
        assert kloop.backward_library(tcfg, M, N) == (
            "scann_loop_backward_tall_bf16" if shape == "tall"
            else "scann_loop_backward_wide_bf16")
    else:
        assert kloop.refusal(tcfg, M, N) is None
        want = {"tall": "scann_loop_tall", "wide 72": "scann_loop_wide",
                "wide 40": "scann_loop"}[shape]
        assert kloop.forward_library(tcfg, M, N)[0] == want


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("case", list(CASES))
def test_torch_bf16_shapes_loop_forward_matches_jax_kernel(case, shape):
    """#3's plain version in bf16 against ``loop_scann_forward(...,
    cfg_bf16, interpret=True)``: pred and ga within JAX's bf16 bound, and
    ``_hold``'s statistics over 5 seeded batches."""
    jax_fns = {}

    def run(seed):
        jcfg, jcfg16, tcfg, f32, jp, tp, x, tx = _setup(10 + seed, shape, False, **CASES[case])
        _check_shape(shape, tcfg, False)
        for c in (jcfg16, jcfg):
            jax_fns.setdefault(c.dtype, jax.jit(
                lambda p, x, c=c: jax_loop.loop_scann_forward(p, x, c, interpret=True)))
        want = [jax_fns[c.dtype](jp, x) for c in (jcfg16, jcfg)]
        want.append(jax_fns["bfloat16"](_jittered(jp, seed), x))
        with torch.no_grad():
            port = [kloop.loop_scann_forward(q, tx, c)
                    for q, c in ((tp, tcfg), (_f64(tp), tcfg), (_jittered(tp, seed), tcfg),
                                 (tp, f32))]
        for g, w in zip(port[0], want[0]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
        as_dict = lambda out: {"pred": np.asarray(out[0], np.float64),
                               "ga": np.asarray(out[1], np.float64)}
        return dict(zip(("p16", "p64", "pjit", "p32", "j16", "j32", "jjit"),
                        map(as_dict, port + want)))

    _hold(run, f"#3 bf16 {case} {shape}")


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("case", list(CASES))
def test_torch_bf16_shapes_loop_train_grads_match_jax_kernel(case, shape, monkeypatch):
    """#4's plain version in bf16 against ``loop_scann_train_grads(...,
    cfg_bf16)`` at dropout 0.1 with attention dropout, on the JAX kernel's
    own masks (drawn in the TPU interpret mode, as
    ``tests/test_torch_stash.py`` draws them): ``_hold``'s statistics over 5
    seeded batches, pred within JAX's bf16 bound."""
    rate = 0.1
    B, M, N, _ = SHAPES[shape]
    jax_fns = {}

    def run(seed):
        jcfg, jcfg16, tcfg, f32, jp, tp, x, tx = _setup(20 + seed, shape, True, **CASES[case])
        _check_shape(shape, tcfg, True)
        masks = _jax_masks("loop", 42 + seed, B, M, N, tcfg, rate)
        monkeypatch.setattr(kbwd, "dropout_masks_for", lambda *a, **k: masks)
        y = np.random.default_rng(300 + seed).normal(size=(B, 1)).astype(np.float32)
        with _interpreted(rate) as interpret:
            for c in (jcfg16, jcfg):
                jax_fns.setdefault(c.dtype, jax.jit(
                    lambda p, x, y, s, c=c: jax_loop.loop_scann_train_grads(
                        p, x, y, c, interpret=interpret, dropout_rate=rate, dropout_seed=s)))
            want = [jax_fns[c.dtype](q, x, y, 42 + seed)
                    for q, c in ((jp, jcfg16), (jp, jcfg), (_jittered(jp, seed), jcfg16))]
        outs = [kloop.loop_scann_train_grads(q, tx, torch.from_numpy(y), c, dropout_rate=rate,
                                             dropout_seed=42 + seed)
                for q, c in ((tp, tcfg), (_f64(tp), tcfg), (_jittered(tp, seed), tcfg),
                             (tp, f32))]
        np.testing.assert_allclose(outs[0][0].numpy(), np.asarray(want[0][0]).reshape(B, -1),
                                   rtol=RTOL, atol=ATOL)
        return dict(zip(("p16", "p64", "pjit", "p32", "j16", "j32", "jjit"),
                        [o[1] for o in outs] + [w[1] for w in want]))

    ratios = _hold(run, f"#4 bf16 {case} {shape} dropout {rate}")
    assert len(ratios) == BATCHES


# --- gates, builds, launches -------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_torch_bf16_shapes_gates_equal_the_f32_gates(name):
    """At every N from 8 to 256 and M across the narrow plans' edges and
    the tall range, a bf16 model's gates, plans, builds and Trainer routes
    are the f32 model's (#4's builds in their bf16 sources)."""
    cfm = CONFIGS[name]
    b16 = dataclasses.replace(cfm, dtype="bfloat16")
    t32, t16 = (train_loop.Trainer(ScannConfig(model=c), "cpu", "unused") for c in (cfm, b16))
    routes = set()
    for N in range(8, 257):
        for M in (24, 96, 128, 217, 226, 227, 232, 237, 238, 243, 244, 300, 573, 968):
            assert kloop.refusal(b16, M, N) == kloop.refusal(cfm, M, N), (M, N)
            assert kloop.backward_refusal(b16, M, N) == kloop.backward_refusal(cfm, M, N), (M, N)
            assert kloop.forward_plan(b16, M, N) == kloop.forward_plan(cfm, M, N)
            assert kloop.backward_plan(b16, M, N) == kloop.backward_plan(cfm, M, N)
            assert kloop.forward_library(b16, M, N) == kloop.forward_library(cfm, M, N)
            lib = kloop.backward_library(cfm, M, N)
            assert kloop.backward_library(b16, M, N) == lib + "_bf16"
            got = (t16.eval_route(M, N), t16.train_route(M, N))
            assert got == (t32.eval_route(M, N), t32.train_route(M, N)), (M, N)
            routes.add(got)
    # as the wide #3 and #4 keep their centers in global memory, every one of
    # these shapes evaluates and trains on a kernel
    assert "loop" in {r for r, _ in routes} and {r for r, _ in routes} <= {"fused", "loop"}
    assert "loop" in {r for _, r in routes} and "per_layer" not in {r for _, r in routes}


def test_torch_bf16_shapes_name_the_bf16_builds():
    """``forward_library`` names #3's wide and tall libraries for bf16 as for
    f32 (each holds both modes), ``backward_library`` #4's bf16 sources,
    and ``Trainer.shape_libraries`` (what ``fit`` and ``warmup_serving``
    build first) the builds a bf16 model's buckets launch: MP2018 (96, 96)
    evaluates wide, (80, 96) and (64, 64) train wide, (300, 32) and (573,
    16) evaluate and train tall, (240, 96) trains and evaluates wide."""
    mp = CONFIGS["mp2018"]
    b16 = dataclasses.replace(mp, dtype="bfloat16")
    assert kloop.forward_library(b16, 96, 96) == ("scann_loop_wide", "scann_loop_forward_wide")
    assert kloop.forward_library(b16, 300, 32) == ("scann_loop_tall", "scann_loop_forward_tall")
    assert kloop.forward_library(b16, 96, 32) == ("scann_loop", "scann_loop_forward")
    assert kloop.backward_library(b16, 80, 96) == "scann_loop_backward_wide_bf16"
    assert kloop.backward_library(b16, 64, 64) == "scann_loop_backward_wide_bf16"
    assert kloop.backward_library(b16, 300, 32) == "scann_loop_backward_tall_bf16"
    assert kloop.backward_library(b16, 573, 16) == "scann_loop_backward_tall_bf16"
    assert kloop.backward_library(b16, 96, 32) == "scann_loop_backward_bf16"
    assert kloop.backward_library(b16, 96, 32, tall=True) == "scann_loop_backward_tall_bf16"
    shapes = [(96, 96, 0), (80, 96, 0), (64, 64, 0), (300, 32, 0), (573, 16, 0), (240, 96, 0)]
    t16 = train_loop.Trainer(ScannConfig(model=b16), "cpu", "unused")
    t32 = train_loop.Trainer(ScannConfig(model=mp), "cpu", "unused")
    assert t16.train_route(240, 96) == "loop" and t16.eval_route(240, 96) == "loop"
    assert t16.shape_libraries(shapes) == t32.shape_libraries(shapes) == (
        "scann_loop_tall", "scann_loop_wide")
    assert t16.shape_libraries(shapes, training=True) == (
        "scann_loop_backward_tall_bf16", "scann_loop_backward_wide_bf16",
        "scann_loop_tall", "scann_loop_wide")
    assert t32.shape_libraries(shapes, training=True) == (
        "scann_loop_backward_tall", "scann_loop_backward_wide",
        "scann_loop_tall", "scann_loop_wide")
    assert set(_build.BF16_SHAPE_SOURCES) <= set(_build.SHAPE_SOURCES)
    assert not set(_build.SHAPE_SOURCES) & set(_build.SOURCES)


@pytest.mark.parametrize("M,N", [(12, 72), (12, 40), (300, 16), (96, 16)])
def test_torch_bf16_shapes_launch_arguments(M, N, monkeypatch):
    """A bf16 launch at a wide or tall shape calls #3's wide or tall library
    with the operand mode 1 in size 22 and the cluster in size 23, and #4's
    bf16 wide or tall library in each schedule (element bytes 0, 4, 2 in
    size 24), with that build's scratch in the last pointer slot; the
    counts move: ``.bf16_launches`` with ``.wide_launches`` or
    ``.tall_launches``. ``tall=True`` forces the bf16 tall builds at a
    narrow shape."""
    calls = _stub(monkeypatch)
    for launcher in (kloop.launch_loop_forward, kloop.launch_loop_backward):
        monkeypatch.setattr(launcher, "tall_launches", 0)
        monkeypatch.setattr(launcher, "bf16_launches", 0)
        monkeypatch.setattr(launcher, "wide_launches", 0)
    cfm = ModelConfig(**dict(SMALL, n_attention=1, embedding_dim=8, local_dim=128,
                             global_dim=128, num_head=8), dtype="bfloat16")
    B = 2
    x = {k: torch.from_numpy(v) for k, v in _wide_batch(np.random.default_rng(M), B, M, N).items()}
    packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0), "cpu"), cfm)
    force = M == 96
    kloop._launch(packed, x, cfm, False, 0.0, 0, 0, 2, tall=force)
    for stash in (None, "f32", "bf16"):
        kloop._launch_backward(packed, x, cfm, torch.zeros(B, 1), None, True, cluster=2,
                               stash=stash, tall=force)
    (lib_f, sym_f, t_f, d_f), *backward = calls
    wide3, wide4 = kloop.is_wide_forward(cfm, N), kloop.is_wide_backward(cfm, N)
    tall3 = force or kloop.is_tall(cfm, M, N)
    tall4 = force or kloop.is_tall_backward(cfm, M, N)
    assert (lib_f, sym_f) == (("scann_loop_wide", "scann_loop_forward_wide") if wide3 else
                              ("scann_loop_tall", "scann_loop_forward_tall") if tall3 else
                              ("scann_loop", "scann_loop_forward"))
    assert (d_f[22], d_f[23]) == (1, 2)
    assert (t_f[-1] is None) == (not wide3 and not tall3)
    want4 = ("scann_loop_backward_wide_bf16" if wide4 else
             "scann_loop_backward_tall_bf16" if tall4 else "scann_loop_backward_bf16")
    assert [(lib, sym) for lib, sym, _, _ in backward] == [(want4, want4)] * 3
    assert [d[24] for _, _, _, d in backward] == [0, 4, 2]
    for _, _, t_b, d_b in backward:
        assert d_b[23] == 2 and (t_b[-1] is None) == (not wide4 and not tall4)
    f3, f4 = kloop.launch_loop_forward, kloop.launch_loop_backward
    assert (f3.bf16_launches, f3.wide_launches, f3.tall_launches) == (1, wide3, tall3)
    assert (f4.bf16_launches, f4.wide_launches, f4.tall_launches) == (3, 3 * wide4, 3 * tall4)
    assert (f4.stash_launches, f4.bf16_stash_launches) == (1, 1)


def test_torch_bf16_shapes_sources_instantiate_the_bf16_kernels():
    """The CUDA sources: #3's wide and tall builds launch
    ``scann_loop_forward_kernel<true, ...>`` for the bf16 flag (no build
    refuses it) and read the flag for their occupancy too; #4's two new
    sources include the f32 source with the wide or tall define and the
    bf16 one, which selects ``launch_backward<true, ...>`` and its own entry
    names and occupancy."""
    with open(f"{_build.SRC_DIR}/scann_loop.cu") as f:
        fwd = f.read()
    assert ("return bf16 ? scann_loop_forward_kernel<true, kWideBuild>\n"
            "              : scann_loop_forward_kernel<false, kWideBuild>;") in fwd
    assert "const auto kernel = build_kernel(bf16);" in fwd
    assert "const auto kernel = build_kernel(dims[22]);" in fwd
    assert "|| bf16" not in fwd and "&& bf16" not in fwd
    with open(f"{_build.SRC_DIR}/scann_loop_backward.cu") as f:
        bwd = f.read()
    assert ("#if defined(SCANN_LOOP_BACKWARD_BF16)\nconstexpr bool kBf16Build = true;\n#else\n"
            "constexpr bool kBf16Build = false;\n#endif") in bwd
    assert "return launch_backward<kBf16Build, kWideBuild>(" in bwd
    assert "return max_clusters<kBf16Build, kWideBuild>(dims, cluster);" in bwd
    assert "launch_backward<false" not in bwd and "launch_backward<true" not in bwd
    for shape, macro in (("wide", "SCANN_LOOP_BACKWARD_WIDE"),
                         ("tall", "SCANN_LOOP_BACKWARD_TALL")):
        name = f"scann_loop_backward_{shape}_bf16"
        assert name in _build.BF16_SHAPE_SOURCES
        with open(f"{_build.SRC_DIR}/{name}.cu") as f:
            text = f.read()
        assert (f"#define {macro}\n#define SCANN_LOOP_BACKWARD_BF16\n"
                '#include "scann_loop_backward.cu"') in text
        assert _build.source_files(name)[1].endswith("/scann_loop_backward.cu")
        assert (f"#define SCANN_LOOP_BACKWARD_ENTRY(x) {name}_##x") in bwd
