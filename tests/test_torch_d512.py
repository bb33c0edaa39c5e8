"""Widths past 256 (D, G, O up to 512) in the forwards #1, #3 and #5 of the
PyTorch port (their ``*_d512`` builds), against the JAX package on the CPU.

- The plain versions against the JAX kernels in interpret mode, on weights
  carried across from the flax parameters (``params_from_jax``) and seeded
  numpy inputs, at (D, G, O) = (264, 260, 268) (a triple no width class
  divides), (384, 384, 384) and (512, 512, 512), B = 2, M <= 12, L = 2, 8
  heads: #1 (``fused_scann_forward``) at N = 8, #3 (``loop_scann_forward``)
  at N = 8 (the tall build) and N = 72 (the wide one), #5
  (``_pallas_forward``) at N = 8 (narrow) and 72 (wide), SCANN+ and SCANN,
  at rtol 1e-5 / atol 1e-6, as ``tests/test_torch_widths.py``.
- The bf16 operand mode by that file's rules: #1 and #3 at (264, 260, 268)
  by ``tests/test_torch_bf16_shapes.py``'s ``_hold`` over 5 seeded batches,
  #5 at D = 384 by ``tests/test_torch_bf16.py``'s (JAX's bound and the
  pooled mean gap within 0.1 x JAX's own gap).
- A D = 384 QM9 model predicting through ``Scann(cfg, device="cpu")``
  against the JAX ``Trainer.forward_eval`` on the same weights, and
  ``params_from_jax`` at D = 384.
- Plans term by term and against the CUDA sources, the builds a launch
  takes (a stub in place of the CUDA library), #1 at the QM9 recipe's
  buckets, and coverage: for D in {260, 320, 384, 448, 512} on the QM9,
  MP2018 and Pt/graphene configs and N from 8 to 128, every (M, N) that a
  JAX forward gate takes (``fits_vmem`` / ``fits_loop_vmem`` with
  ``training=False``) gets a port route whose kernel's gate takes it, and
  no plan of that route raises.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import jit_init_vars, make_synthetic_batch
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.config import ScannConfig as JaxScannConfig
from scann_tpu.kernels import local_attention as jla
from scann_tpu.kernels.scann_forward import fits_vmem
from scann_tpu.kernels.scann_forward import fused_scann_forward as jax_fused_forward
from scann_tpu.kernels.scann_loop import fits_loop_vmem
from scann_tpu.kernels.scann_loop import loop_scann_forward as jax_loop_forward
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu.train.loop import Trainer as JaxTrainer
from scann_tpu_torch.api import Scann
from scann_tpu_torch.compat import params_from_jax
from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig
from scann_tpu_torch.data.structure import Structure
from scann_tpu_torch.kernels import _build
from scann_tpu_torch.kernels import local_attention as kla
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.kernels import widths
from scann_tpu_torch.models import init_params
from scann_tpu_torch.train import loop as train_loop
from test_torch_bf16_shapes import _f64, _hold, _jittered
from test_torch_widths import _assert_bf16, _flat_params, _layer_inputs

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL, BF16_ATOL = 0.05, 0.02
LAYER_BATCHES = 6
# the JAX kernel's f32 layer from the plain layer in float64, on the layer
# test's inputs (outputs of scale 0.03 to 6): 2.8e-6 at most, at D = 512
JAX_F64_ATOL = 1e-5
SMALL = dict(n_atoms=10, embedding_dim=16, n_attention=2, num_head=8)
WIDTHS = {"264-260-268": dict(local_dim=264, global_dim=260, dense_out=268),
          "384": dict(local_dim=384, global_dim=384, dense_out=384),
          "512": dict(local_dim=512, global_dim=512, dense_out=512)}
RECIPE = dict(num_head=8, scale=0.5, use_attn_norm=True, use_ga_norm=True)
# the repo's three configs (configs/model_{qm9,mp2018,ptgp}.yaml), widths set per case
CONFIGS = {
    "qm9": dict(n_atoms=10, embedding_dim=48, n_attention=7, g_update=True, gaussian_d=4.0),
    "mp2018": dict(n_atoms=95, embedding_dim=128, n_attention=9, g_update=True,
                   gaussian_d=6.0),
    "ptgp": dict(n_atoms=80, embedding_dim=48, n_attention=11, g_update=False, use_ring=True,
                 gaussian_d=4.0),
}
BUILDS = {"fused": "scann_forward_d512", "tall": "scann_loop_tall_d512",
          "wide": "scann_loop_wide_d512"}


def _width(cfm, D, G=None, O=None, heads=8):
    return dataclasses.replace(cfm, local_dim=D, global_dim=G or D, dense_out=O or D,
                               num_head=heads)


QM9 = _width(ModelConfig(**CONFIGS["qm9"], **RECIPE), 512)
MP2018 = _width(ModelConfig(**CONFIGS["mp2018"], **RECIPE), 512)


def _torch(x):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}


def _setup(width, seed, M=12, N=8, dtype="float32"):
    jcfg = JaxModelConfig(**SMALL, **WIDTHS[width])
    tcfg = ModelConfig(**SMALL, **WIDTHS[width], dtype=dtype)
    x = make_synthetic_batch(np.random.default_rng(seed), B=2, M=M, N=N)
    jp = jax.device_get(jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(seed), x))
    return jcfg, tcfg, jp, params_from_jax(jp, tcfg), x


def _reset_counts():
    for c in (kfwd.fused_scann_forward, kloop.launch_loop_forward, kla.fused_local_attention):
        for name in ("launches", "bf16_launches", "wide_launches", "tall_launches",
                     "d256_launches", "d512_launches"):
            if hasattr(c, name):
                setattr(c, name, 0)


# --- #1 and #3: the whole-model forwards ----------------------------------------------

@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("kernel", ["fused", "tall", "wide"])
def test_torch_d512_whole_model_plain_matches_jax_kernel(kernel, width):
    """#1's and #3's plain versions (the wrappers on CPU tensors) against the
    JAX kernels in interpret mode past 256 columns, where the port's gates
    take the shape and name the *_d512 build: #1 and the tall #3 at N = 8,
    the wide #3 at N = 72 (past 256 columns N > 16 is wide)."""
    M, N = (10, 72) if kernel == "wide" else (12, 8)
    jcfg, tcfg, jp, tp, x = _setup(width, 51, M=M, N=N)
    assert kfwd.width_class(tcfg) == 512
    if kernel == "fused":
        assert kfwd.refusal(tcfg, M, N) is None and kfwd.library(tcfg) == BUILDS["fused"]
        want = jax_fused_forward(jp, x, jcfg, interpret=True, batch_tile=1)
        with torch.no_grad():
            got = kfwd.fused_scann_forward(tp, _torch(x), tcfg)
    else:
        assert kloop.refusal(tcfg, M, N) is None
        assert kloop.forward_library(tcfg, M, N)[0] == BUILDS[kernel]
        want = jax_loop_forward(jp, x, jcfg, interpret=True)
        with torch.no_grad():
            got = kloop.loop_scann_forward(tp, _torch(x), tcfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    assert kfwd.fused_scann_forward.d512_launches == kloop.launch_loop_forward.d512_launches == 0


@pytest.mark.parametrize("kernel", ["fused", "loop"])
def test_torch_d512_bf16_plain_matches_jax_kernel(kernel):
    """#1's and #3's plain versions in the bf16 operand mode against the JAX
    kernels at model.dtype bfloat16 at (264, 260, 268), by ``_hold``'s
    statistics (``tests/test_torch_widths.py`` says why the rule holds at a
    triple that divides no width and the card holds D = 384 and 512)."""
    width = "264-260-268"
    jk, port, extra = ((jax_fused_forward, kfwd.fused_scann_forward, {"batch_tile": 1})
                       if kernel == "fused" else (jax_loop_forward, kloop.loop_scann_forward, {}))
    fns = {}

    def run(seed):
        jcfg, tcfg, jp, tp, x = _setup(width, 60 + seed, dtype="bfloat16")
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

@pytest.mark.parametrize("D,N", [(264, 8), (384, 8), (384, 72), (512, 8), (512, 72)])
@pytest.mark.parametrize("g_update", [True, False])
def test_torch_d512_layer_matches_jax_kernel(D, N, g_update):
    """#5's plain version (``fused_local_attention`` on CPU tensors) against
    the JAX per-layer kernel in interpret mode past 256 columns, at a narrow
    N (the d512 narrow build takes N <= 16) and a wide one."""
    rng = np.random.default_rng(D + N + 1)
    centers, idx, geometry, mask, weight, params = _layer_inputs(rng, 2, 10, N, D, g_update)
    H, scale = 8, 0.5
    kla.check_supported(D, N, geometry.shape[-1], H, torch.float32)
    assert kla.library(N, D) == ("local_attention_wide_d512" if N > 16 else
                                 "local_attention_d512")
    want = jla._pallas_forward(*[jnp.asarray(a) for a in (centers, idx, geometry, mask, weight)],
                               params, H, scale, g_update, interpret=True)
    tensors = [torch.from_numpy(a) for a in (centers, idx, geometry, mask, weight)]
    with torch.no_grad():
        out, geo, attn = kla.fused_local_attention(*tensors, _flat_params(params), H, scale,
                                                   g_update)
        f64 = kla.reference_local_attention(
            *[t if t.dtype == torch.int32 else t.double() for t in tensors],
            {k: v.double() for k, v in _flat_params(params).items()}, H, scale, g_update)
    for i, got in ((0, out), (2, attn)) + (((1, geo),) if g_update else ()):
        _assert_f32(got.numpy(), np.asarray(want[i]), f64[i].numpy())
    assert kla.fused_local_attention.launches == kla.fused_local_attention.d512_launches == 0


def _assert_f32(got, want, plain64):
    """The JAX kernel within ``JAX_F64_ATOL`` of the plain layer in float64
    (so that the float64 layer stands confirmed by the JAX package, and an
    error of the port's plain formula fails here whichever branch follows);
    then ``got`` within rtol/atol of the JAX kernel's ``want``, or, where f32
    sum-order noise alone crosses atol (#5's geometry at D = 512: a
    LayerNorm over 512 columns of 1,536-term sums), no further from the
    float64 layer than the JAX kernel is from it, within a factor of 2."""
    port, jax_own = np.abs(got - plain64).max(), np.abs(want - plain64).max()
    assert jax_own <= JAX_F64_ATOL, (jax_own, JAX_F64_ATOL)
    if np.allclose(got, want, rtol=RTOL, atol=ATOL):
        return
    assert port <= 2 * jax_own, (port, jax_own)


def test_torch_d512_layer_bf16_matches_jax_kernel():
    """#5's plain version on bfloat16 tensors against ``_pallas_forward`` on
    the same bfloat16 inputs at D = 384, by the bf16 rule."""
    B, M, N, D, H = 2, 10, 8, 384, 8
    run = jax.jit(lambda c, i, g, m, p: jla._pallas_forward(c, i, g, m, None, p, H, 0.5, True,
                                                            interpret=True))
    got, want, want32 = [], [], []
    for seed in range(LAYER_BATCHES):
        centers, idx, geometry, mask, _, params = _layer_inputs(
            np.random.default_rng(70 + seed), B, M, N, D)

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

def test_torch_d512_scann_predicts_as_the_jax_trainer():
    """``Scann(cfg, device="cpu")`` of a QM9 model at D = G = O = 384 (two
    layers), with the flax model's weights (``load_params``), predicts a
    batch of two molecules through ``predict_featurized`` (the eval route
    "fused", #1's plain version) as the JAX ``Trainer.forward_eval`` does on
    the same weights: the un-standardized property and the GA scores."""
    qm9 = dict(CONFIGS["qm9"], n_attention=2)
    jcfg = JaxModelConfig(**qm9, **RECIPE, **WIDTHS["384"])
    tcfg = ModelConfig(**qm9, **RECIPE, **WIDTHS["384"])
    x = make_synthetic_batch(np.random.default_rng(34), B=2, M=12, N=8)
    jp = jax.device_get(jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(34), x))
    hyper = HyperConfig(target_mean=-0.2, target_std=0.03)
    jtrainer = JaxTrainer(JaxScannConfig(model=jcfg))
    want_p, want_ga = jtrainer.forward_eval(jp["params"],
                                            {k: jnp.asarray(v) for k, v in x.items()})
    ts = Scann(ScannConfig(model=tcfg, hyper=hyper), device="cpu")
    ts.load_params(jp)
    assert ts.trainer.eval_route(12, 8) == "fused" and kfwd.library(tcfg) == BUILDS["fused"]
    counts = x["atom_mask"][:, :, 0].sum(1).astype(int)
    rng = np.random.default_rng(34)
    structs = [Structure(["C"] * n, rng.uniform(0, 5, size=(n, 3))) for n in counts]
    got = ts.predict_featurized(structs, [{k: v[b:b + 1] for k, v in x.items()}
                                          for b in range(2)])
    for b, (value, ga) in enumerate(got):
        prop = np.asarray(want_p)[b, 0] * hyper.target_std + hyper.target_mean
        np.testing.assert_allclose(np.float32(value), np.float32(prop), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ga, np.asarray(want_ga)[b, :counts[b], 0], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("config", ["qm9", "ptgp"])
def test_torch_d512_params_from_jax(config):
    """``params_from_jax`` carries a D = 384 model across unchanged (every
    tensor's shape and value is flax's), and the kernels' layout of it
    (``pack_params``) holds the TF32 planes every forward past 128 columns
    reads, in both model variants."""
    jcfg = JaxModelConfig(**CONFIGS[config], **RECIPE, **WIDTHS["384"])
    tcfg = ModelConfig(**CONFIGS[config], **RECIPE, **WIDTHS["384"])
    x = make_synthetic_batch(np.random.default_rng(5), B=2, M=12, N=8,
                             use_ring=tcfg.use_ring)
    jp = jax.device_get(jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(5), x))
    tp = params_from_jax(jp, tcfg)

    def flatten(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            yield from (flatten(v, key) if hasattr(v, "items") else [(key, np.asarray(v))])

    flat = dict(flatten(jp["params"]))
    assert set(tp) == set(flat)
    for k, v in flat.items():
        assert tuple(tp[k].shape) == v.shape and np.array_equal(tp[k].numpy(), v), k
    own = init_params(tcfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: v.shape for k, v in flat.items()}
    packed = kfwd.pack_params(tp, tcfg)
    D, K = 384, tcfg.num_gaussian
    per_layer = (kfwd.layer_tf32_planes(packed["wfg"][0], packed["wk"][0], packed["wq"][0],
                                        tcfg.g_update).numel()
                 + 2 * kfwd.tf32_planes(packed["wr1"][0]).numel())
    assert tuple(packed["tf32_planes"].shape) == (tcfg.n_attention, per_layer)
    hi, lo, _ = kfwd.unpack_tf32_planes(kfwd.tf32_planes(packed["wk"][0]), D, D)
    assert torch.equal(hi + lo, packed["wk"][0]) and K <= D


# --- plans, sources, routes and launches ----------------------------------------------

def _source(name):
    with open(f"{_build.SRC_DIR}/{name}") as f:
        return f.read()


def test_torch_d512_plans_match_cuda_sources():
    """The Python mirrors against the CUDA sources past 256 columns: the
    16-row chunks and sub-chunks, #5's narrow limit and atom blocks, the
    loop forward's tall limit, #1's L2 rows (pointer 51) and resident
    count, and the builds' entry points."""
    common = _source("scann_forward_common.cuh")
    assert ("#ifdef SCANN_WIDTH_512\nconstexpr int kFwdWideW32Rows = 16;\n#else\n"
            "constexpr int kFwdWideW32Rows = 32;\n#endif") in common
    d512 = widths.class_of(512)
    assert d512.wide_forward_rows == d512.chunk_rows == 16
    # the wide context past 256 columns: a thread's columns tid and tid + 256
    assert "if constexpr (kLaneValues > 8) {" in common
    assert "for (int d = tid; d < D; d += kThreads) {" in common
    la = _source("local_attention.cu")
    assert ("#ifdef SCANN_WIDTH_512\nconstexpr int kD256ChunkRows = 16;   // past 256 columns\n"
            "#else\nconstexpr int kD256ChunkRows = 32;\n#endif") in la
    assert ("constexpr int kNarrowMaxN = kLaneValues > 8 ? kD256ChunkRows : kFwdMaxChunkRows;"
            in la)
    assert "(a.N > kNarrowMaxN) != kWide ||" in la
    assert kla.narrow_max_n(512) == 16 and kla.narrow_max_n(256) == kla.narrow_max_n(32) == 64
    loop = _source("scann_loop.cu")
    assert "kLaneValues > 8 ? 16 :" in loop and d512.tall_max_n == 16
    fwd = _source("scann_forward.cu")
    assert "p.offWork = (kL2Rows ? 1 : 3) * a.M * p.ldm;" in fwd
    assert "float* l2rows = (float*)ptrs[51];" in fwd
    assert "float* sQ = l2rows + (size_t)b * 2 * M * ldm;" in fwd
    assert kfwd.l2_rows_shape(QM9, 16, 32) == (16, 2, 32, 516)
    assert kfwd.l2_rows_shape(_width(QM9, 256), 16, 32) is None
    for name in ("scann_forward_d512", "scann_loop_tall_d512", "scann_loop_wide_d512",
                 "local_attention_d512", "local_attention_wide_d512"):
        src = _source(f"{name}.cu")
        assert "#define SCANN_WIDTH_256\n#define SCANN_WIDTH_512\n" in src
        assert name in _build.WIDTH_SOURCES and name in _build.SHAPE_SOURCES


@pytest.mark.parametrize("D,M,want", [
    (512, 32, (1, 24832, 171680)), (384, 32, (2, 37376, 203936)),
    (264, 32, (2, 25856, 141072)), (512, 16, (1, 24832, 138592))])
def test_torch_d512_fused_plan_keeps_the_centers_alone(D, M, want):
    """#1's plan past 256 columns at QM9 (M, 16), term by term as
    ``make_plan`` of ``csrc/scann_forward.cu`` lays it out: the centers
    [M, ldm] alone (the query and scratch rows are in L2), the first of 64,
    32 and 16 rows a chunk that fits, the readout's vectors. With three
    resident arrays D = 512 would need 303,776 bytes at M = 32."""
    cfm = _width(QM9, D, 260 if D == 264 else D, 268 if D == 264 else D)
    assert kfwd.shared_memory_plan(cfm, M, 16) == want
    chunk_atoms, work, nbytes = want
    ldm = max(cfm.local_dim, cfm.global_dim) + 4
    assert work == kfwd.forward_chunk_floats(chunk_atoms * 16, D, 8)
    assert nbytes == 4 * (M * ldm + work + 2 * ldm + M + cfm.dense_out)
    if D == 512 and M == 32:
        assert 4 * (3 * M * ldm + work + 2 * ldm + M + cfm.dense_out) > kfwd.MAX_SHARED_BYTES
    assert kfwd.refusal(cfm, M, 16) is None


@pytest.mark.parametrize("D,M,N,want", [
    (512, 96, 16, (1, 16)), (512, 322, 8, (2, 16)), (384, 96, 16, (1, 16)),
    (264, 96, 16, (2, 16))])
def test_torch_d512_tall_plan_takes_16_row_chunks(D, M, N, want):
    """The tall #3's plan past 256 columns: the first of 64, 32 and 16 rows
    a chunk whose plan fits, counted term by term as ``l2_plan`` of
    ``csrc/scann_loop.cu`` lays it out; the tall build takes N <= 16."""
    cfm = _width(MP2018, D)
    chunk_atoms, block, work, nbytes, keys = kloop.l2_memory_plan(cfm, M, N)
    assert (chunk_atoms, block) == want and not keys
    assert not kloop.is_wide_forward(cfm, N) and kloop.is_tall(cfm, M, N)
    rows, wd = chunk_atoms * N, D
    front = max(rows * (D + 4) + -(-rows * 8 // 4) * 4, block * (wd + 4))
    chunk = front + 2 * rows * (2 * D + 4) + -(-2 * rows // 4) * 4 + 4
    r4M = -(-M // 4) * 4
    assert work == max(chunk, block * wd + 2 * wd + 2 * r4M + D)
    assert nbytes == 4 * (2 * block * (wd + 4) + work) <= kloop.MAX_SHARED_BYTES
    assert kloop.is_wide_forward(cfm, 17)


@pytest.mark.parametrize("D,M,N,want", [
    (512, 96, 32, (16, 231952)), (512, 80, 96, (8, 201488)), (512, 40, 256, (8, 207888)),
    (384, 80, 96, (16, 177168))])
def test_torch_d512_wide_plan_takes_16_row_sub_chunks(D, M, N, want):
    """The wide #3's plan past 256 columns: two operand buffers of 16 rows,
    the atom's energies [N, H] in the front, the keys in L2, term by term."""
    cfm = _width(MP2018, D)
    chunk_atoms, block, work, nbytes, keys = kloop.l2_memory_plan(cfm, M, N)
    assert (block, nbytes) == want and chunk_atoms == 1 and not keys
    rows, wd, r4 = 16, D, lambda v: -(-v // 4) * 4
    front = max(rows * (D + 4) + r4(N * 8), block * (wd + 4))
    chunk = front + 2 * rows * (2 * D + 4) + r4(2 * N) + 4
    assert work == max(chunk, block * wd + 2 * wd + 2 * r4(M) + D)
    assert nbytes == 4 * (2 * block * (wd + 4) + work)
    assert kloop.wide_keys_shape_for(cfm, 4, M, N, 2) == (8, N, D)


@pytest.mark.parametrize("D,N,bf16,want", [
    (512, 16, False, (1, 2, 198144)), (512, 16, True, (1, 2, 230912)),
    (512, 8, False, (2, 2, 198144)), (384, 12, True, (1, 2, 136384))])
def test_torch_d512_narrow_layer_plan(D, N, bf16, want):
    """#5's narrow plan past 256 columns at a block of 8 atoms: chunks of at
    most 16 rows, two operand buffers (and the bf16 raw area) where they
    fit, else one, term by term as ``d256_plan_for`` lays it out."""
    assert kla.d256_block_plan(8, N, D, 8, True, bf16) == want
    chunk_atoms, buffers, nbytes = want
    rows = chunk_atoms * N
    front = max(rows * (D + 4) + -(-rows * 8 // 4) * 4, 8 * (D + 4))
    floats = 2 * 8 * (D + 4) + front + buffers * rows * (2 * D + 4)
    assert nbytes == 4 * (floats + (rows * D if bf16 and buffers == 2 else 0))
    assert not kla.is_wide(N, D) and kla.is_wide(17, D)


def test_torch_d512_wide_layer_plan():
    """#5's wide plan past 256 columns: two buffers of 16 rows, the keys in
    L2 past where they fit, atom blocks from ``WIDE_ATOM_BLOCKS``."""
    for D, N, bf16 in ((512, 32, False), (512, 256, True), (384, 96, False)):
        for ab in kla.WIDE_ATOM_BLOCKS:
            plan = kla.wide_block_plan(ab, N, D, 8, True, bf16)
            if plan is None:
                continue
            buffers, keys, nbytes = plan
            r4 = lambda v: -(-v // 4) * 4
            off_a = max(16 * (D + 4) + r4(N * 8), ab * (D + 4))
            floats = (2 * ab * (D + 4) + off_a + 2 * 16 * (2 * D + 4)
                      + (16 * D if bf16 else 0) + r4(2 * N) + (N * D if keys else 0))
            assert buffers == 2 and nbytes == 4 * floats <= kla.MAX_SHARED_BYTES
    assert kla.make_plan(1, 5, 256, 512, 8, True, 132, True)[0] >= 1


def _trainer(cfm):
    return train_loop.Trainer(ScannConfig(model=cfm), device="cpu")


@pytest.mark.parametrize("D", [384, 512])
@pytest.mark.parametrize("cfm,M,N,route,library", [
    (QM9, 32, 16, "fused", "scann_forward_d512"),
    (QM9, 12, 8, "fused", "scann_forward_d512"),
    (MP2018, 96, 16, "loop", "scann_loop_tall_d512"),
    (MP2018, 96, 32, "loop", "scann_loop_wide_d512"),
    (MP2018, 80, 96, "loop", "scann_loop_wide_d512"),
    (MP2018, 322, 12, "loop", "scann_loop_tall_d512"),
    (dataclasses.replace(MP2018, use_attn_norm=False), 96, 16, "per_layer",
     "local_attention_d512"),
    (dataclasses.replace(MP2018, use_attn_norm=False), 96, 32, "per_layer",
     "local_attention_wide_d512"),
])
def test_torch_d512_eval_routes_take_a_kernel(cfm, M, N, route, library, D):
    """At D = G = O = 384 and 512 the recipe buckets and the tall and wide
    crystals evaluate on a *_d512 build (#5's for the per-layer model), which
    the Trainer builds before a fit or a served ladder (``shape_libraries``);
    training takes #4's d512 build (its tall build at N <= 16, the wide one
    past it), the per-layer route only where #4 refuses the model (no
    attention LayerNorm), and a fit builds that build too."""
    cfm = _width(cfm, D)
    trainer = _trainer(cfm)
    assert trainer.eval_route(M, N) == route
    assert trainer.shape_libraries([(M, N, 0)]) == (library,)
    if not cfm.use_attn_norm:
        assert trainer.train_route(M, N) == "per_layer"
        assert trainer.shape_libraries([(M, N, 0)], training=True) == (library,)
        return
    train = f"scann_loop_backward_{'tall' if N <= 16 else 'wide'}_d512"
    assert trainer.train_route(M, N) == "loop"
    assert kloop.backward_library(cfm, M, N) == train
    assert trainer.shape_libraries([(M, N, 0)], training=True) == tuple(sorted((library, train)))


@pytest.mark.parametrize("D", [384, 512])
@pytest.mark.parametrize("B", [1, 16, 128])
def test_torch_d512_fused_takes_qm9_buckets(B, D, monkeypatch):
    """#1 past 256 columns takes the QM9 recipe's buckets (M <= 32, N = 16;
    the packed slots of capacity 32 with 8 segments too) at D = 384 and 512
    and B = 1, 16 and 128, at a cluster of at most one block a chunk of
    atoms (the card's answers stubbed: 132 SMs, one block an SM)."""
    cfm = _width(QM9, D)
    monkeypatch.setattr(kfwd, "max_active_clusters",
                        lambda cfm, B, M, N, C, S=0: 132 // C)
    trainer = _trainer(cfm)
    for M in range(1, 33):
        assert kfwd.refusal(cfm, M, 16) is None and trainer.eval_route(M, 16) == "fused"
        C = kfwd.forward_cluster(cfm, B, M, 16)
        assert 1 <= C <= kfwd.chunk_count(cfm, M, 16) and (B * C <= 132 or C == 1)
    assert kfwd.refusal(cfm, 32, 16, 8) is None
    assert kfwd.forward_cluster(cfm, 1, 32, 16) == 16


@pytest.mark.parametrize("route", ["fused", "tall", "wide", "layer", "layer wide"])
def test_torch_d512_launch_the_d512_builds(route, monkeypatch):
    """The launch wrappers hand a D = 512 batch to the *_d512 library with
    their own plan (a stub in place of the CUDA library) and count it: #1
    with its L2 rows as pointer 51 and the planes as pointer 50."""
    seen = []
    monkeypatch.setattr(kfwd, "call_kernel", lambda *a, **k: seen.append(a))
    monkeypatch.setattr(kloop, "max_active_forward_clusters", lambda *a, **k: 132)
    monkeypatch.setattr(kfwd, "max_active_clusters", lambda *a, **k: 132)
    monkeypatch.setattr(kla, "sm_count", lambda dev: 132)
    cfm = dataclasses.replace(MP2018, n_attention=1)
    _reset_counts()
    if route in ("fused", "tall", "wide"):
        M, N = {"fused": (12, 6), "tall": (40, 16), "wide": (10, 48)}[route]
        x = _torch(make_synthetic_batch(np.random.default_rng(0), B=2, M=M, N=N, n_atoms=95))
        packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0)), cfm)
        if route == "fused":
            kfwd._launch(packed, x, cfm, False)
            want = ("scann_forward_d512", "scann_forward_d512")
            counter = kfwd.fused_scann_forward
            tensors = seen[0][3]
            assert tensors[50] is packed["tf32_planes"]
            assert tuple(tensors[51].shape) == kfwd.l2_rows_shape(cfm, 2, 12) == (2, 2, 12, 516)
            with pytest.raises(ValueError, match="l2_rows"):
                kfwd._launch(packed, x, cfm, False, l2_rows=torch.empty(2, 2, 12, 260))
        else:
            kloop._launch(packed, x, cfm, False)
            want = kloop.forward_library(cfm, M, N)
            assert want[0] == f"scann_loop_{route}_d512"
            counter = kloop.launch_loop_forward
            chunk_atoms, block, work, _ = kloop.forward_plan(cfm, M, N)
            assert seen[0][4][16:18] == [chunk_atoms, work] and seen[0][4][20] == block
            assert len(seen[0][3]) == 53 and seen[0][3][52] is packed["tf32_planes"]
    else:
        N = 96 if route == "layer wide" else 12
        rng = np.random.default_rng(1)
        c, i, g, m, w, p = _layer_inputs(rng, 2, 10, N, 512)
        kla._launch(*[torch.from_numpy(a) for a in (c, i, g, m, w)], _flat_params(p), 8, 0.5,
                    True)
        want = (kla.library(N, 512),) * 2
        counter = kla.fused_local_attention
        assert seen[0][4][8:] == list(kla.make_plan(2, 10, N, 512, 8, True, 132))
        assert counter.wide_launches == (N > 16)
    assert seen[0][:2] == want
    assert counter.launches == counter.d512_launches == 1 and counter.d256_launches == 0
    _reset_counts()


# --- coverage: every shape a JAX forward gate takes ----------------------------------

def _jax_largest_m(fits, jcfg, N, top):
    """The largest M <= top that ``fits`` takes at N (0 where none does);
    the gates grow with M, so a bisection finds it."""
    lo, hi = 0, top
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(jcfg, mid, N):
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("D", [260, 320, 384, 448, 512])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_torch_d512_coverage(config, D):
    """For D = G = O past 256 (4 heads at D = 260, which 8 do not divide) at
    each N from 8 to 128: every (M, N) that the JAX molecule or loop
    forward takes (``fits_vmem`` / ``fits_loop_vmem`` with
    ``training=False``), and M up to 2,000 for the per-layer kernel, which
    has no gate there, gets a port route (``Trainer.eval_route``) whose
    kernel's gate takes it and whose plan and launch sizes raise nothing (a
    whole-model kernel wherever a JAX whole-model kernel takes the shape):
    #1's plan and cluster count, #3's plan and scratch shapes, #5's plan in
    f32 and bf16 and its supported sizes."""
    heads = 4 if D == 260 else 8
    jcfg = JaxModelConfig(**CONFIGS[config], **RECIPE, local_dim=D, global_dim=D, dense_out=D)
    jcfg = dataclasses.replace(jcfg, num_head=heads)
    cfm = _width(ModelConfig(**CONFIGS[config], **RECIPE), D, heads=heads)
    trainer = _trainer(cfm)
    fused = lambda c, M, N: fits_vmem(c, M, N, training=False)
    loop = lambda c, M, N: fits_loop_vmem(c, M, N, training=False)
    taken = 0
    for N in range(8, 129):
        top1 = _jax_largest_m(fused, jcfg, N, 64)
        top3 = _jax_largest_m(loop, jcfg, N, 4096)
        Ms = sorted({*range(1, max(top1, top3) + 1, 1 if N % 8 == 0 else 5), top1, top3,
                     500, 2000} - {0})
        for M in Ms:
            taken += M <= max(top1, top3)
            route = trainer.eval_route(M, N)
            if route == "fused":
                assert kfwd.refusal(cfm, M, N) is None
                chunk_atoms, work, nbytes = kfwd.shared_memory_plan(cfm, M, N)
                assert nbytes <= kfwd.MAX_SHARED_BYTES and kfwd.chunk_count(cfm, M, N) >= 1
                assert kfwd.l2_rows_shape(cfm, 1, M) is not None
            elif route == "loop":
                assert kloop.refusal(cfm, M, N) is None, (M, N)
                assert kloop.forward_plan(cfm, M, N)[3] <= kloop.MAX_SHARED_BYTES
                kloop.loop_forward_scratch(cfm, 1, M, N, "meta", cluster=1)
                assert kloop.forward_library(cfm, M, N)[0] in _build.WIDTH_SOURCES
            else:
                assert route == "per_layer"
                K = D if cfm.g_update else cfm.num_gaussian
                kla.check_supported(D, N, K, heads, torch.float32)
                for bf16 in (False, True):
                    kla.make_plan(1, M, N, D, heads, cfm.g_update, 132, bf16)
                assert kla.library(N, D) in _build.WIDTH_SOURCES
            # what a JAX whole-model kernel takes, a port whole-model kernel takes
            assert route != "per_layer" or M > max(top1, top3), (M, N, route)
    assert taken > 0
