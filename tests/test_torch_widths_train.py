"""Training at widths above 128 (D, G, O up to 256) on the crystal loop
backward (#4) of the PyTorch port: its tall and wide builds of widths up to
256 (``csrc/scann_loop_backward_{tall,wide}_d256.cu`` and their ``_bf16``
twins), against the JAX package on the CPU.

- The plain versions (the wrappers on CPU tensors) against the JAX loop
  backward in interpret mode, on weights carried across from the flax
  parameters and seeded numpy inputs, at (D, G, O) = (136, 132, 140) (a
  width that does not divide 256) and (256, 256, 256), B = 2, M = 8, L = 2,
  8 heads, at N = 8 (the tall build) and N = 40 (the wide one): one-shot
  and cotangent gradients within 2e-5 x each gradient's max, pred at rtol
  1e-5 / atol 1e-6, as ``tests/test_torch_loop_backward.py``.
- The selective stash: the f32 stash's plain walk (``reference_loop_stash_
  train_grads(mode="f32")``) equals the plain gradients, and the bf16 stash
  holds to the JAX kernel's with ``loop_stash_mode`` forced to "bf16", by
  ``tests/test_torch_stash.py``'s per-tensor rule.
- The bf16 operand mode by ``tests/test_torch_bf16_shapes.py``'s ``_hold``
  over 5 seeded batches (JAX's bf16 bound on pred; each batch's mean gap to
  JAX in bf16 within the larger of 0.1 x JAX's own bf16-vs-f32 gap and 2 x
  the batch's f32-noise floor, and below the port's f32 result's).
- Gates, plans, routes and launches: the route table of a D = 256 model
  (QM9 (32, 16) on "loop", which #2 refuses past 128 columns), #4's gate
  against the TPU's at D = 256, the d256 plans term by term and against the
  CUDA sources, and the builds a launch takes (a stub in place of the CUDA
  library), through the sharded wrapper too.
"""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from conftest import jit_init_vars, make_synthetic_batch
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.kernels import scann_loop as jax_loop
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu_torch.compat import params_from_jax
from scann_tpu_torch.config import ModelConfig, ScannConfig
from scann_tpu_torch.kernels import _build
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.kernels import sharded
from scann_tpu_torch.models import init_params
from scann_tpu_torch.parallel.mesh import RankLayout
from scann_tpu_torch.train import loop as train_loop
from test_torch_bf16_shapes import _f64, _hold, _jittered
from test_torch_stash import _hold as _stash_hold
from test_torch_widths import MP2018, QM9, RECIPE

torch.set_num_threads(1)

GRAD_TOL = 2e-5
RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL, BF16_ATOL = 0.05, 0.02
SMALL = dict(n_atoms=10, embedding_dim=16, n_attention=2, num_head=8)
WIDTHS = {"136-132-140": dict(local_dim=136, global_dim=132, dense_out=140),
          "256": dict(local_dim=256, global_dim=256, dense_out=256)}
B, M = 2, 8
BUILDS = {8: "scann_loop_backward_tall_d256", 40: "scann_loop_backward_wide_d256"}


def _torch(x):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}


def _setup(width, seed, N, dtype="float32"):
    """(JAX f32 config, the port's config, JAX params, the port's params,
    numpy inputs, torch inputs) of one seeded batch at (B, M, N)."""
    jcfg = JaxModelConfig(**SMALL, **WIDTHS[width])
    tcfg = ModelConfig(**SMALL, **WIDTHS[width], dtype=dtype)
    x = make_synthetic_batch(np.random.default_rng(seed), B=B, M=M, N=N)
    jp = jax.device_get(jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(seed), x))
    return jcfg, tcfg, jp, params_from_jax(jp, tcfg), x, _torch(x)


def _flat(tree):
    return {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_grads(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                                   atol=GRAD_TOL * (np.abs(w).max() + 1e-8),
                                   err_msg=f"gradient of {k}")


# --- the plain versions against the JAX loop backward ----------------------------------

@pytest.mark.parametrize("N", list(BUILDS))
@pytest.mark.parametrize("width", list(WIDTHS))
def test_torch_widths_train_plain_matches_jax_kernel(width, N):
    """#4's plain version (``loop_scann_train_grads`` and ``loop_scann_grad``
    on CPU tensors) against the JAX loop backward in interpret mode past 128
    columns, where the gate takes the shape in the d256 build."""
    jcfg, tcfg, jp, tp, x, tx = _setup(width, 40 + N, N)
    assert kloop.backward_refusal(tcfg, M, N) is None
    assert kloop.backward_library(tcfg, M, N) == BUILDS[N]
    y = np.linspace(-1, 1, B, dtype=np.float32)
    jpred, jraw = jax_loop.loop_scann_train_grads(jp, x, y, jcfg, interpret=True)
    pred, raw = kloop.loop_scann_train_grads(tp, tx, torch.from_numpy(y), tcfg)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=RTOL, atol=ATOL)
    _assert_grads(raw, _flat(jraw))
    rng = np.random.default_rng(3)
    ct = (rng.normal(size=(B, 1)).astype(np.float32),
          rng.normal(size=(B, M, 1)).astype(np.float32))
    want = _flat(jax_loop.loop_scann_grad(jp, x, jcfg, *ct, interpret=True))
    _assert_grads(kloop.loop_scann_grad(tp, tx, tcfg, *map(torch.from_numpy, ct)), want)
    assert kloop.launch_loop_backward.d256_launches == 0


@pytest.mark.parametrize("N", list(BUILDS))
@pytest.mark.parametrize("width", list(WIDTHS))
def test_torch_widths_train_stash_references_match_jax_kernel(width, N, monkeypatch):
    """The selective stash's plain versions past 128 columns: the f32
    stash's walk gives the plain gradients (the kernel's f32 stash is bit
    for bit its recompute schedule), and the bf16 stash holds to the JAX
    kernel's bf16 stash (``loop_stash_mode`` forced to "bf16" there) by the
    per-tensor rule of ``tests/test_torch_stash.py``."""
    jcfg, tcfg, jp, tp, x, tx = _setup(width, 60 + N, N)
    y = np.random.default_rng(5).normal(size=(B, 1)).astype(np.float32)
    ty = torch.from_numpy(y)
    pred32, p32 = kloop.reference_loop_train_grads(tp, tx, ty, tcfg)
    pred_st, p_st = kloop.reference_loop_stash_train_grads(tp, tx, ty, tcfg, mode="f32")
    torch.testing.assert_close(pred_st, pred32, rtol=RTOL, atol=ATOL)
    for k in p32:
        torch.testing.assert_close(p_st[k], p32[k], rtol=0,
                                   atol=GRAD_TOL * float(p32[k].abs().max() + 1e-8))
    want = {}
    for mode in ("bf16", "f32"):
        monkeypatch.setattr(jax_loop, "loop_stash_mode", lambda *a, mode=mode, **k: mode)
        want[mode] = jax_loop.loop_scann_train_grads(jp, x, y, jcfg, interpret=True)
    pred16, p16 = kloop.reference_loop_stash_train_grads(tp, tx, ty, tcfg, mode="bf16")
    np.testing.assert_allclose(pred16.numpy(), np.asarray(want["bf16"][0]).reshape(B, -1),
                               rtol=1e-4, atol=1e-5)
    _stash_hold(p16, p32, want["bf16"][1], want["f32"][1], f"#4 d256 {width} N={N}")


@pytest.mark.parametrize("N", list(BUILDS))
@pytest.mark.parametrize("width", list(WIDTHS))
def test_torch_widths_train_bf16_plain_matches_jax_kernel(width, N):
    """#4's plain version in the bf16 operand mode against the JAX loop
    backward at model.dtype bfloat16 (one-shot, dropout 0): pred within
    JAX's bf16 bound and ``_hold``'s statistics over 5 seeded batches."""
    fns = {}

    def run(seed):
        jcfg, tcfg, jp, tp, x, tx = _setup(width, 80 + seed, N, dtype="bfloat16")
        assert kloop.backward_library(tcfg, M, N) == BUILDS[N] + "_bf16"
        jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
        f32 = dataclasses.replace(tcfg, dtype="float32")
        y = np.random.default_rng(300 + seed).normal(size=(B, 1)).astype(np.float32)
        for c in (jcfg16, jcfg):
            fns.setdefault(c.dtype, jax.jit(lambda p, x, y, c=c: jax_loop.loop_scann_train_grads(
                p, x, y, c, interpret=True)))
        want = [fns[c.dtype](q, x, y) for q, c in ((jp, jcfg16), (jp, jcfg),
                                                   (_jittered(jp, seed), jcfg16))]
        outs = [kloop.loop_scann_train_grads(q, tx, torch.from_numpy(y), c)
                for q, c in ((tp, tcfg), (_f64(tp), tcfg), (_jittered(tp, seed), tcfg),
                             (tp, f32))]
        np.testing.assert_allclose(outs[0][0].numpy(), np.asarray(want[0][0]).reshape(B, -1),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)
        return dict(zip(("p16", "p64", "pjit", "p32", "j16", "j32", "jjit"),
                        [o[1] for o in outs] + [w[1] for w in want]))

    _hold(run, f"#4 bf16 {width} N={N}")


# --- gates, plans, routes and launches ---------------------------------------------------

def _trainer(cfm):
    return train_loop.Trainer(ScannConfig(model=cfm), device="cpu")


@pytest.mark.parametrize("cfm,M_,N,route,library", [
    (QM9, 32, 16, "loop", "scann_loop_backward_tall_d256"),
    (QM9, 64, 8, "loop", "scann_loop_backward_tall_d256"),
    (MP2018, 96, 32, "loop", "scann_loop_backward_tall_d256"),
    (MP2018, 322, 32, "loop", "scann_loop_backward_tall_d256"),
    (MP2018, 48, 96, "loop", "scann_loop_backward_wide_d256"),
    (MP2018, 80, 96, "loop", "scann_loop_backward_wide_d256"),
    (MP2018, 240, 256, "loop", "scann_loop_backward_wide_d256"),
    (dataclasses.replace(MP2018, dtype="bfloat16"), 96, 32, "loop",
     "scann_loop_backward_tall_d256_bf16"),
    (dataclasses.replace(MP2018, dtype="bfloat16"), 48, 96, "loop",
     "scann_loop_backward_wide_d256_bf16"),
    (dataclasses.replace(MP2018, local_dim=192, global_dim=192, dense_out=192), 96, 32, "loop",
     "scann_loop_backward_tall_d256"),
    (dataclasses.replace(MP2018, use_attn_norm=False), 96, 32, "per_layer", None),
    (dataclasses.replace(MP2018, local_dim=516, num_head=4), 96, 32, "per_layer", None),
    (dataclasses.replace(MP2018, local_dim=260, num_head=4), 96, 32, "loop",
     "scann_loop_backward_wide_d512"),
    (MP2018, 20000, 256, "per_layer", None),
])
def test_torch_widths_train_routes(cfm, M_, N, route, library):
    """A model wider than 128 trains on #4's d256 builds wherever their
    plans fit: the recipe buckets of QM9 and MP2018 at D = 256 (QM9's, which
    #2 takes at D = 128, too), tall and wide crystals, bf16 in its own
    sources; past 256 columns the d512 builds, whose tall build takes N <=
    16 (``backward_tall_max_n``); the per-layer route is left to what no
    gate takes (no attention LayerNorm, D past 512, a plan past a block),
    and the Trainer
    builds the route's library before a fit (``shape_libraries``)."""
    trainer = _trainer(cfm)
    assert trainer.train_route(M_, N) == route
    if library is None:
        assert kloop.backward_refusal(cfm, M_, N) is not None
        return
    assert kloop.backward_library(cfm, M_, N) == library
    assert library in _build.WIDTH_SOURCES and library in _build.SHAPE_SOURCES
    assert library in trainer.shape_libraries([(M_, N, 0)], training=True)
    assert kloop.is_tall_backward(cfm, M_, N) == (N <= kloop.backward_tall_max_n(cfm))


def test_torch_widths_train_packed_routes():
    """A packed slot past 128 columns takes the d256 build where its plan
    holds the slot's segments; past ``backward_max_segments`` the gate names
    the plan and the Trainer takes the per-layer route."""
    trainer = _trainer(QM9)
    for M_, N in ((48, 16), (32, 16), (96, 32)):
        most = kloop.backward_max_segments(QM9, M_, N)
        assert most >= 8
        assert trainer.train_route(M_, N, most) == "loop"
        assert kloop.backward_library(QM9, M_, N, most) == "scann_loop_backward_tall_d256"
    big = kloop.backward_max_segments(QM9, 4000, 16)
    assert 0 < big < kfwd.MAX_SEGMENTS
    reason = kloop.backward_refusal(QM9, 4000, 16, big + 1)
    assert reason is not None and "shared memory" in reason
    assert trainer.train_route(4000, 16, big + 1) == "per_layer"


def test_torch_widths_backward_gate_against_the_tpu_kernel():
    """At D = G = O = 256 the port's #4 takes every M that the TPU's loop
    backward takes (``fits_loop_vmem(training=True)``) at every N of QM9,
    MP2018 and Pt/graphene; #2 takes none of them (its limit stays 128)."""
    ptgp = ModelConfig(n_atoms=80, embedding_dim=48, n_attention=11, use_ring=True,
                       g_update=False, gaussian_d=4.0, **RECIPE)
    for cfm in (QM9, MP2018, ptgp):
        jcfg = JaxModelConfig(**{f.name: getattr(cfm, f.name)
                                 for f in dataclasses.fields(JaxModelConfig)
                                 if hasattr(cfm, f.name)})
        for N in (8, 16, 32, 48, 96, 256):
            tpu = max([m for m in range(1, 512) if jax_loop.fits_loop_vmem(jcfg, m, N,
                                                                             training=True)],
                      default=0)
            assert kloop.backward_refusal(cfm, max(tpu, 1), N) is None, (cfm.n_atoms, N, tpu)
            assert kloop.backward_refusal(cfm, 1024, N) is None
            assert kbwd.refusal(cfm, min(tpu, 32) or 1, min(N, 32)) is not None


@pytest.mark.parametrize("D,N,want", [
    (256, 32, (1, 8)), (256, 16, (2, 8)), (256, 8, (4, 8)), (192, 32, (1, 16)),
    (136, 32, (2, 8)), (136, 16, (4, 8))])
def test_torch_widths_tall_backward_plan(D, N, want):
    """The tall #4's plan past 128 columns, term by term as ``make_plan`` of
    ``csrc/scann_loop_backward.cu`` lays it out: the first of 64, 32 and 16
    rows a chunk whose plan fits at some atom block (32 rows with blocks of
    8 at D = 256, about 228 KB; 64 at D = 136), no resident buffer."""
    cfm = dataclasses.replace(MP2018, local_dim=D, global_dim=D, dense_out=D)
    chunk_atoms, block, nbytes = kloop.backward_plan(cfm, 96, N)
    assert (chunk_atoms, block) == want
    r4 = lambda v: -(-v // 4) * 4
    wd, rows, H, O = D, chunk_atoms * N, 8, D
    work = max(rows * (2 * D + 4) + 3 * rows * (D + 4) + 3 * r4(rows * H),
               5 * block * wd + r4(block), block * 2 * 128 + block * wd,
               block * wd + 4 * wd + 5 * 96 + 3 * O + 4)
    assert nbytes == 4 * (5 * block * wd + work + 8 * 2 * wd + 2 * wd) <= kloop.MAX_SHARED_BYTES
    assert rows == (32 if D == 256 else rows) and rows <= kloop.TALL_CHUNK_ROWS
    if D == 256:
        assert nbytes == 228352


@pytest.mark.parametrize("D,N,want", [(256, 96, (4, 32)), (256, 40, (8, 32)),
                                      (192, 96, (16, 32)), (136, 96, (8, 64)),
                                      (136, 48, (8, 64)), (152, 96, (32, 32))])
def test_torch_widths_wide_backward_plan(D, N, want):
    """The wide #4's plan past 128 columns: sub-chunks of the first of
    ``D256_WIDE_CHUNK_ROWS`` = (64, 32) rows that fits (64 only with atom
    blocks of 8 or more: 64 at D = 136, 32 at D = 152 and beyond) beside
    the atom's attention and d attention [N, H] and the d query sum, and
    the largest atom block that fits (4 at MP2018 (80, 96) and D = 256,
    212,992 bytes)."""
    cfm = dataclasses.replace(MP2018, local_dim=D, global_dim=D, dense_out=D)
    chunk_atoms, block, nbytes = kloop.backward_plan(cfm, 80, N)
    rows = kloop.wide_sub_chunk(cfm, 80, N)
    assert (block, rows) == want and chunk_atoms == 1
    assert rows in kloop.D256_WIDE_CHUNK_ROWS
    r4 = lambda v: -(-v // 4) * 4
    wd, H = D, 8
    work = max(rows * (2 * D + 4) + 3 * rows * (D + 4) + 2 * r4(N * H) + r4(rows * H) + wd,
               5 * block * wd + r4(block), block * 2 * 128 + block * wd,
               block * wd + 4 * wd + 5 * 80 + 3 * D + 4)
    assert nbytes == 4 * (5 * block * wd + work + 8 * 2 * wd + 2 * wd) <= kloop.MAX_SHARED_BYTES
    if (D, N) == (256, 96):
        assert nbytes == 212992


def test_torch_widths_backward_plans_match_cuda_sources():
    """The Python mirrors of #4's d256 builds against the CUDA sources: the
    four sources' defines, the wide sub-chunk, the tall chunk limit, the
    launcher's width check, the entry points, and the templated LayerNorm
    helpers of ``scann_grad_common.cuh``."""
    src = open(f"{_build.SRC_DIR}/scann_loop_backward.cu").read()
    assert "constexpr int kWideChunkRows = 64;" in src
    assert (kloop.D256_WIDE_CHUNK_ROWS, kloop.WIDE_CHUNK_ROWS) == ((64, 32), 64)
    assert ("    if (p.total * (int)sizeof(float) <= kMaxSharedBytes) return p;\n"
            "    return make_plan<kWide>(a, kWideChunkRows / 2);") in src
    assert "constexpr int kMaxCluster = kLaneValues > 4 ? 8 : 4;" in src
    assert kloop.D256_CLUSTER_SIZES == tuple(range(8, 0, -1))
    assert "constexpr int kTallChunkRows = 64;" in src and kloop.TALL_CHUNK_ROWS == 64
    assert max(kfwd.CHUNK_ROWS) == kloop.TALL_CHUNK_ROWS
    assert "a.D > kMaxWidth || a.G > kMaxWidth || a.O > kMaxWidth ||" in src
    assert "a.D > 128" not in src
    for name in ("tall_d256", "wide_d256", "tall_d256_bf16", "wide_d256_bf16"):
        lib = f"scann_loop_backward_{name}"
        assert f"#define SCANN_LOOP_BACKWARD_ENTRY(x) {lib}_##x" in src
        text = open(f"{_build.SRC_DIR}/{lib}.cu").read()
        assert "#define SCANN_WIDTH_256\n" in text and '#include "scann_loop_backward.cu"' in text
        assert ("#define SCANN_LOOP_BACKWARD_TALL\n" in text) == ("tall" in name)
        assert ("#define SCANN_LOOP_BACKWARD_WIDE\n" in text) == ("wide" in name)
        assert ("#define SCANN_LOOP_BACKWARD_BF16\n" in text) == name.endswith("bf16")
        assert _build.source_files(lib)[1].endswith("scann_loop_backward.cu")
        assert lib in _build.WIDTH_SOURCES
    # every warp row of the reverse walk holds kLaneValues values a lane
    walk = src[src.index("auto row_forward = [&]"):src.index("// The sizes make_plan reads")]
    assert not re.search(r"float (v|dy|xh|dx)\[4\]", walk) and "i < 4;" not in walk
    grad = open(f"{_build.SRC_DIR}/scann_grad_common.cuh").read()
    assert "template <int V>\n__device__ __forceinline__ void warp_ln_stats(" in grad
    assert "template <int V>\n__device__ __forceinline__ void warp_ln_backward(" in grad


def _stub(monkeypatch):
    seen = []
    monkeypatch.setattr(kfwd, "call_kernel", lambda *a, **k: seen.append(a))
    return seen


@pytest.mark.parametrize("N", list(BUILDS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_widths_launch_the_d256_backward_builds(N, dtype, monkeypatch):
    """``_launch_backward`` hands a D = 256 batch to the d256 library of its
    build and mode with its own plan (a stub in place of the CUDA library)
    and counts it (``.d256_launches`` beside ``.tall_launches`` /
    ``.wide_launches``), in each schedule."""
    seen = _stub(monkeypatch)
    monkeypatch.setattr(kloop, "max_active_clusters", lambda cfm, B, M, N, C, S=0: 15)
    cfm = dataclasses.replace(MP2018, n_attention=1, dtype=dtype)
    x = _torch(make_synthetic_batch(np.random.default_rng(0), B=2, M=10, N=N, n_atoms=95))
    packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0)), cfm)
    y = torch.zeros(2)
    c = kloop.launch_loop_backward
    kbwd.reset_counts(c)
    for stash in (None, "f32", "bf16"):
        kloop._launch_backward(packed, _torch({k: v.numpy() for k, v in x.items()}), cfm, y,
                               None, True, stash=stash)
    want = BUILDS[N] + ("_bf16" if dtype == "bfloat16" else "")
    chunk_atoms, block, _ = kloop.backward_plan(cfm, 10, N)
    for call in seen:
        assert call[:2] == (want, want)
        dims = call[4]
        assert dims[3] == 256 and dims[18] == chunk_atoms and dims[21] == block
        assert dims[23] == 8          # backward_cluster: 2 structures, 15 clusters of 8 at once
    assert [call[4][24] for call in seen] == [0, 4, 2]
    tall = N <= 32
    assert (c.launches, c.d256_launches, c.tall_launches, c.wide_launches) == (
        3, 3, 3 * tall, 3 * (not tall))
    assert c.bf16_launches == 3 * (dtype == "bfloat16")
    kbwd.reset_counts(c)


def test_torch_widths_sharded_train_takes_the_d256_build(monkeypatch):
    """The data-parallel step (``make_sharded_loop_train`` with the launch a
    Trainer passes as its ``local``) takes the d256 build on a rank's rows,
    its ``mol_base`` the rows' first global index."""
    seen = _stub(monkeypatch)
    monkeypatch.setattr(kloop, "max_active_clusters", lambda cfm, B, M, N, C, S=0: 15)
    cfm = dataclasses.replace(MP2018, n_attention=1)
    x = _torch(make_synthetic_batch(np.random.default_rng(1), B=2, M=10, N=16, n_atoms=95))
    params = init_params(cfm, torch.Generator().manual_seed(0))
    packed = kfwd.pack_params(params, cfm)

    def local(params, rows, y, seed, base):
        flat, pred = kloop._launch_backward(packed, rows, cfm, y, None, True, False, 0.1, seed,
                                            base)
        return pred.view(-1, 1), kbwd.grads_from_flat(flat, packed, cfm)

    step = sharded.make_sharded_loop_train(RankLayout(1, 0, torch.device("cpu")), cfm,
                                           local=local)
    kbwd.reset_counts(kloop.launch_loop_backward)
    pred, raw = step(params, x, np.zeros(2, np.float32), 7)
    assert pred.shape == (2, 1) and set(raw) == set(params)
    assert [call[:2] for call in seen] == [("scann_loop_backward_tall_d256",) * 2]
    assert kloop.launch_loop_backward.d256_launches == 1
    kbwd.reset_counts(kloop.launch_loop_backward)
