"""Training past 256 columns (D, G, O up to 512) on the crystal loop backward
(#4) of the PyTorch port: its tall and wide builds of widths up to 512
(``csrc/scann_loop_backward_{tall,wide}_d512.cu`` and their ``_bf16``
twins), against the JAX package on the CPU.

- The plain versions (the wrappers on CPU tensors) against the JAX loop
  backward in interpret mode, on weights carried across from the flax
  parameters and seeded numpy inputs, at (D, G, O) = (264, 260, 268), 384
  and 512, B = 2, M = 8, L = 2, 8 heads, at N = 8 and 16 (the tall build:
  N <= 16 past 256 columns) and N = 24 and 40 (the wide one): one-shot
  gradients within 2e-5 x each gradient's max and pred at rtol 1e-5 / atol
  1e-6, as ``tests/test_torch_widths_train.py``; cotangent gradients at N =
  16 and 40.
- The selective stash: the f32 stash's plain walk equals the plain
  gradients, and the bf16 stash holds to the JAX kernel's with
  ``loop_stash_mode`` forced to "bf16", by ``tests/test_torch_stash.py``'s
  per-tensor rule.
- The bf16 operand mode at (264, 260, 268) by
  ``tests/test_torch_bf16_shapes.py``'s ``_hold`` over its seeded batches.
- One ``Trainer`` step of a D = 384 QM9 model (two layers) at dropout 0,
  which trains on "loop" (#4's tall d512 build), against the JAX Trainer's
  one-shot loop step on the same weights and batch (its
  ``loop_scann_train_grads`` in interpret mode, the 1 / (n rmse) scale, the
  l2 gradient and Adam): loss to 1e-4 relative, every tensor within 1e-4 x
  its max.
- Plans, routes, launches and coverage: the d512 plans term by term and
  against the CUDA sources, every plan and route of widths up to 256 held
  to the rule they had, the builds a launch takes (a stub in place of the
  CUDA library), through the sharded wrapper too, and every (M, N) that the
  TPU's #4 or #2 trains at D in (256, 512] on the three configs taking a
  kernel here.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import jit_init_vars, make_synthetic_batch
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.kernels import scann_loop as jax_loop
from scann_tpu.kernels.scann_forward import fits_vmem
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu.models.scann import l2_penalty as jax_l2_penalty
from scann_tpu_torch.compat import params_from_jax
from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig
from scann_tpu_torch.kernels import _build
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.kernels import sharded, widths
from scann_tpu_torch.models import init_params
from scann_tpu_torch.parallel.mesh import RankLayout
from scann_tpu_torch.train import loop as train_loop
from test_torch_bf16_shapes import _f64, _hold, _jittered
from test_torch_d512 import CONFIGS, RECIPE, _jax_largest_m, _width
from test_torch_stash import _hold as _stash_hold

torch.set_num_threads(1)

GRAD_TOL = 2e-5
RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL, BF16_ATOL = 0.05, 0.02
SMALL = dict(n_atoms=10, embedding_dim=16, n_attention=2, num_head=8)
WIDTHS = {"264-260-268": dict(local_dim=264, global_dim=260, dense_out=268),
          "384": dict(local_dim=384, global_dim=384, dense_out=384),
          "512": dict(local_dim=512, global_dim=512, dense_out=512)}
B, M = 2, 8
BUILDS = {8: "scann_loop_backward_tall_d512", 16: "scann_loop_backward_tall_d512",
          24: "scann_loop_backward_wide_d512", 40: "scann_loop_backward_wide_d512"}
QM9 = _width(ModelConfig(**CONFIGS["qm9"], **RECIPE), 384)
MP2018 = _width(ModelConfig(**CONFIGS["mp2018"], **RECIPE), 384)


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

@pytest.mark.parametrize("width,N", [("264-260-268", 8), ("264-260-268", 24), ("384", 16),
                                     ("384", 40), ("512", 16), ("512", 40)])
def test_torch_d512_train_plain_matches_jax_kernel(width, N):
    """#4's plain version (``loop_scann_train_grads``, and at D = 384 and 512
    with N = 16 and 40 ``loop_scann_grad``, on CPU tensors) against the JAX
    loop backward in interpret mode past 256 columns, each width at a tall
    and a wide N, where the gate takes the shape in the d512 build of its
    N."""
    jcfg, tcfg, jp, tp, x, tx = _setup(width, 40 + N, N)
    assert kloop.backward_refusal(tcfg, M, N) is None
    assert kloop.backward_library(tcfg, M, N) == BUILDS[N]
    y = np.linspace(-1, 1, B, dtype=np.float32)
    jpred, jraw = jax_loop.loop_scann_train_grads(jp, x, y, jcfg, interpret=True)
    pred, raw = kloop.loop_scann_train_grads(tp, tx, torch.from_numpy(y), tcfg)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=RTOL, atol=ATOL)
    _assert_grads(raw, _flat(jraw))
    if width != "264-260-268":
        rng = np.random.default_rng(3)
        ct = (rng.normal(size=(B, 1)).astype(np.float32),
              rng.normal(size=(B, M, 1)).astype(np.float32))
        want = _flat(jax_loop.loop_scann_grad(jp, x, jcfg, *ct, interpret=True))
        _assert_grads(kloop.loop_scann_grad(tp, tx, tcfg, *map(torch.from_numpy, ct)), want)
    assert kloop.launch_loop_backward.d512_launches == 0


@pytest.mark.parametrize("width,N", [("264-260-268", 40), ("512", 16)])
def test_torch_d512_train_stash_references_match_jax_kernel(width, N, monkeypatch):
    """The selective stash's plain versions past 256 columns: the f32
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
    _stash_hold(p16, p32, want["bf16"][1], want["f32"][1], f"#4 d512 {width} N={N}")


def test_torch_d512_train_bf16_plain_matches_jax_kernel():
    """#4's plain version in the bf16 operand mode at (264, 260, 268)
    against the JAX loop backward at model.dtype bfloat16 (one-shot, dropout
    0) at N = 24, the wide bf16 build's shape (the plain version is one
    function for both builds): pred within JAX's bf16 bound and ``_hold``'s
    statistics over its seeded batches."""
    width, N = "264-260-268", 24
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


def test_torch_d512_trainer_step_matches_jax_trainer_step():
    """One ``Trainer.train_step`` of a D = 384 QM9 model (two layers, dropout
    0) on "loop", #4's tall d512 build (its plain version on the CPU),
    against the JAX Trainer's one-shot loop step on the same weights and
    batch (``scann_tpu/train/loop.py``: ``loop_scann_train_grads``, here in
    interpret mode, the 1 / (n rmse) scale, the l2 gradient, Adam with eps
    1e-7): the loss to 1e-4 relative, the raw gradients within 2e-5 x each
    one's max, both moments after the step each within 1e-4 x its max, and
    the weights within 0.1 x the learning rate: Adam's first step moves a
    weight by lr g / (|g| + eps), so a gradient element at the f32 noise
    level moves it by a share of lr however close the gradients are."""
    small = dict(CONFIGS["qm9"], n_attention=2)
    jcfg = JaxModelConfig(**small, **RECIPE, local_dim=384, global_dim=384, dense_out=384)
    tcfg = _width(ModelConfig(**small, **RECIPE), 384)
    batch = make_synthetic_batch(np.random.default_rng(7), B=4, M=12, N=16)
    y = np.linspace(-1.0, 1.0, 4).astype(np.float32)
    assert jax_loop.fits_loop_vmem(jcfg, 12, 16, training=True)
    jparams = jax.device_get(jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(0),
                                           batch)["params"])
    params0 = jparams
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-7)
    lr = 5e-4
    pred, raw = jax_loop.loop_scann_train_grads(jparams, batch, y, jcfg, interpret=True)
    rmse = jnp.sqrt(jnp.mean((pred[:, 0] - y) ** 2))
    l2g = jax.grad(lambda p: jax_l2_penalty(p, 1e-4))(jparams)
    g = jax.tree.map(lambda r, g2: r / (y.shape[0] * rmse) + g2, raw, l2g)
    opt = tx.init(jparams)
    upd, opt = tx.update(g, opt, jparams)
    jloss = rmse + jax_l2_penalty(jparams, 1e-4)
    jparams = optax.apply_updates(jparams, jax.tree.map(lambda u: -lr * u, upd))

    trainer = train_loop.Trainer(ScannConfig(model=tcfg, hyper=HyperConfig(batch_size=4)), "cpu")
    trainer.load_params(params_from_jax(params0, tcfg))
    trainer.dropout_rate = 0.0
    assert trainer.train_route(12, 16) == "loop"
    assert kloop.backward_library(tcfg, 12, 16) == "scann_loop_backward_tall_d512"
    _, mine_raw = trainer.raw_grads(_torch(batch), torch.from_numpy(y), seed=0)
    _assert_grads(mine_raw, _flat(raw))
    loss, _ = trainer.train_step(_torch(batch), torch.from_numpy(y), lr, seed=0)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    for mine, ref in ((trainer.mu, opt.mu), (trainer.nu, opt.nu)):
        for k, r in params_from_jax(jax.device_get(ref), tcfg).items():
            torch.testing.assert_close(mine[k], r, rtol=0, atol=1e-4 * float(r.abs().max()),
                                       msg=k)
    for k, r in params_from_jax(jax.device_get(jparams), tcfg).items():
        torch.testing.assert_close(trainer.params[k], r, rtol=0, atol=0.1 * lr, msg=k)


# --- plans, routes, launches and coverage ------------------------------------------------

def _trainer(cfm):
    return train_loop.Trainer(ScannConfig(model=cfm), device="cpu")


def _plan_bytes(cfm, M, N, block, rows, wide, S=0):
    """``make_plan<kWide>(a, rows).total`` of ``csrc/scann_loop_backward.cu`` in
    bytes, term by term, for the tall (``wide`` False: ``rows`` the chunk's)
    and wide builds."""
    r4 = lambda v: -(-v // 4) * 4
    D, G, O, H = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.num_head
    wd = max(D, G)
    lde = r4(cfm.embedding_dim + (10 if cfm.use_ring else 0))
    if wide:
        chunk = rows * (2 * D + 4) + 3 * rows * (D + 4) + 2 * r4(N * H) + r4(rows * H) + wd
    else:
        chunk = rows * (2 * D + 4) + 3 * rows * (D + 4) + 3 * r4(rows * H)
    work = max(chunk, 5 * block * wd + r4(block), block * 2 * lde + block * wd,
               block * wd + 4 * wd + 5 * r4(M) + 3 * r4(O) + 4)
    if S:
        work = max(work, block * wd + kfwd.seg_backward_floats(S, wd, M, O))
    return 4 * (5 * block * wd + work + 8 * 2 * wd + 2 * wd)


@pytest.mark.parametrize("D,N,want", [
    (384, 16, (1, 8, 16, 214528)), (384, 8, (2, 8, 16, 214528)),
    (512, 16, (1, 2, 16, 223744)), (512, 8, (2, 2, 16, 223744)), (512, 12, (1, 4, 12, 202624)),
    (384, 24, (1, 8, 16, 216576)), (384, 256, (1, 8, 16, 231424)),
    (512, 64, (1, 2, 16, 228864)), (512, 120, (1, 2, 16, 232448)),
    (512, 121, (1, 1, 16, 222272)), (512, 256, (1, 1, 16, 230912)),
])
def test_torch_d512_backward_plans(D, N, want):
    """#4's plans past 256 columns, term by term as ``make_plan`` of
    ``csrc/scann_loop_backward.cu`` lays them out: the tall build (N <= 16)
    in chunks of 16 rows of whole atoms, the wide one in sub-chunks of 16
    rows, each with the largest atom block that fits a block's 227 KB (8 at
    D = 384; at D = 512 2, and 1 in the wide build past N = 120), no
    resident buffer."""
    cfm = _width(MP2018, D)
    chunk_atoms, block, nbytes = kloop.backward_plan(cfm, 96, N)
    wide = kloop.is_wide_backward(cfm, N)
    assert wide == (N > 16) and kloop.backward_tall_max_n(cfm) == 16
    rows = kloop.wide_sub_chunk(cfm, 96, N) if wide else chunk_atoms * N
    assert (chunk_atoms, block, rows, nbytes) == want
    assert nbytes == _plan_bytes(cfm, 96, N, block, rows, wide) <= kloop.MAX_SHARED_BYTES
    if not wide:
        assert rows <= 16 and chunk_atoms == 16 // N
        # the next larger block does not fit
        bigger = widths.class_of(D).tall_backward[0][1]
        nxt = bigger[bigger.index(block) - 1] if block != bigger[0] else None
        assert nxt is None or _plan_bytes(cfm, 96, N, nxt, rows, False) > kloop.MAX_SHARED_BYTES


def _parent_plan(cfm, M, N, S, tall):
    """The loop backward's plan as it was before the d512 builds (the rule of
    widths up to 256, written out here): tall chunks of 64 rows up to 128
    columns and the first of 64, 32, 16 past it; wide sub-chunks of 64 rows
    up to 128 columns and past it 64 with blocks of 8 or more, else 32."""
    r4 = lambda v: -(-v // 4) * 4
    D, G, O, H = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.num_head
    wd = max(D, G)
    lde = r4(cfm.embedding_dim + (10 if cfm.use_ring else 0))
    ldf = r4(kbwd.CGCNN_FEATURES) if cfm.feature == "cgcnn" else 0
    wide, d256 = N > 32, max(D, G, O) > 128
    caps = ((64, 32) if d256 else (64,)) if wide else (
        ((64, 32, 16) if d256 else (64,)) if tall else (32,))
    first = None
    for cap in caps:
        blocks = (32, 16, 8) if not wide or (d256 and cap == 64) else (32, 16, 8, 4)
        for block in blocks:
            block = min(block, M)
            chunk_atoms = max(1, min(block, cap // max(N, 1)))
            if wide:
                rows = cap
                chunk = rows * (2 * D + 4) + 3 * rows * (D + 4) + 2 * r4(N * H) + r4(rows * H) + wd
            else:
                rows = chunk_atoms * N
                chunk = rows * (2 * D + 4) + 3 * rows * (D + 4) + 3 * r4(rows * H)
            work = max(chunk, 5 * block * wd + r4(block), block * (2 * lde + ldf) + block * wd,
                       block * wd + 4 * wd + 5 * r4(M) + 3 * r4(O) + 4)
            if S:
                work = max(work, block * wd + kfwd.seg_backward_floats(S, wd, M, O))
            floats = (0 if tall or wide else M * wd) + 5 * block * wd + work + 16 * wd + 2 * wd
            if 4 * floats <= kloop.MAX_SHARED_BYTES:
                return chunk_atoms, block, 4 * floats, rows
        first = first or (chunk_atoms, block, 4 * floats, rows)
    return first


@pytest.mark.parametrize("D", [64, 128, 136, 200, 256])
def test_torch_d512_narrower_plans_and_routes_unchanged(D):
    """Every plan, build and route of widths up to 256 is the one it was
    before the d512 builds (``_parent_plan``, the rule written out): the
    narrow, tall and wide plans at every N of a grid, packed too, the wide
    build past N = 32, the builds' names and the gate."""
    for base in (QM9, MP2018):
        cfm = _width(base, D)
        for N in (4, 8, 12, 16, 24, 31, 32, 33, 40, 48, 64, 65, 96, 130, 200, 256):
            assert kloop.is_wide_backward(cfm, N) == (N > 32)
            for Mx in (1, 7, 32, 96, 226, 240, 322, 1000):
                for S in (0, 8):
                    tall = kloop.is_tall_backward(cfm, Mx, N, S)
                    want = _parent_plan(cfm, Mx, N, S, tall)
                    assert tall == (N <= 32 and (D > 128 or _parent_plan(
                        cfm, Mx, N, S, False)[2] > kloop.MAX_SHARED_BYTES))
                    assert kloop.backward_plan(cfm, Mx, N, S) == want[:3], (N, Mx, S)
                    if N > 32:
                        assert kloop.wide_sub_chunk(cfm, Mx, N, S) == want[3]
                    lib = kloop.backward_library(cfm, Mx, N, S)
                    suffix = "_d256" if D > 128 else ""
                    assert lib == ("scann_loop_backward_wide" + suffix if N > 32 else
                                   "scann_loop_backward_tall" + suffix if tall else
                                   "scann_loop_backward")
                    fits = want[2] <= kloop.MAX_SHARED_BYTES
                    assert (kloop.backward_refusal(cfm, Mx, N, S) is None) == fits


def test_torch_d512_backward_plans_match_cuda_sources():
    """The Python mirrors of #4's d512 builds against the CUDA sources: the
    four sources' defines, the tall N and the chunk rows past 256 columns,
    the plan's d512 branch, the launcher's checks, the gather's transpose
    past 256 columns, the entry points and ``_build.WIDTH_SOURCES``."""
    src = open(f"{_build.SRC_DIR}/scann_loop_backward.cu").read()
    assert "constexpr bool kD512 = kLaneValues > 8;" in src
    assert "constexpr int kTallMaxN = kD512 ? 16 : kMaxChunkRows;" in src
    assert "constexpr int kD512ChunkRows = 16;" in src
    rows = {r for c in widths.CLASSES[2:] for r, _ in c.tall_backward + c.wide_backward}
    assert rows == {16} and widths.class_of(512).backward_tall_max_n == 16
    assert [c.backward_tall_max_n for c in widths.CLASSES[:2]] == [kbwd.MAX_CHUNK_ROWS] * 2
    assert ("  if constexpr (kWide && kD512) {\n    return make_plan<kWide>(a, kD512ChunkRows);\n"
            "  } else if constexpr (kWide && kD256) {") in src
    assert "if ((a.N > kTallMaxN) != kWide ||" in src
    assert "(kD512 && !kWide && a.chunk_atoms * a.N > kD512ChunkRows) ||" in src
    assert re.search(r"if constexpr \(kD512\)\s+if \(sc_d \+ kThreads < D\)\s+tall_scatter", src)
    assert "constexpr int kMaxCluster = kLaneValues > 4 ? 8 : 4;" in src
    assert kloop.BACKWARD_MAX_WIDTH == widths.MAX_WIDTH == kfwd.MAX_WIDTH == 512
    for name in ("tall_d512", "wide_d512", "tall_d512_bf16", "wide_d512_bf16"):
        lib = f"scann_loop_backward_{name}"
        assert f"#define SCANN_LOOP_BACKWARD_ENTRY(x) {lib}_##x" in src
        text = open(f"{_build.SRC_DIR}/{lib}.cu").read()
        assert "#define SCANN_WIDTH_256\n#define SCANN_WIDTH_512\n" in text
        assert '#include "scann_loop_backward.cu"' in text
        assert ("#define SCANN_LOOP_BACKWARD_TALL\n" in text) == ("tall" in name)
        assert ("#define SCANN_LOOP_BACKWARD_WIDE\n" in text) == ("wide" in name)
        assert ("#define SCANN_LOOP_BACKWARD_BF16\n" in text) == name.endswith("bf16")
        assert _build.source_files(lib)[1].endswith("scann_loop_backward.cu")
        assert lib in _build.WIDTH_SOURCES and lib in _build.SHAPE_SOURCES
    grad = open(f"{_build.SRC_DIR}/scann_grad_common.cuh").read()
    assert "16 in those past 256" in grad


@pytest.mark.parametrize("cfm,M_,N,library", [
    (QM9, 32, 16, "scann_loop_backward_tall_d512"),
    (QM9, 22, 16, "scann_loop_backward_tall_d512"),
    (QM9, 31, 32, "scann_loop_backward_wide_d512"),
    (MP2018, 96, 32, "scann_loop_backward_wide_d512"),
    (MP2018, 322, 12, "scann_loop_backward_tall_d512"),
    (MP2018, 240, 256, "scann_loop_backward_wide_d512"),
    (_width(MP2018, 512), 96, 16, "scann_loop_backward_tall_d512"),
    (_width(MP2018, 264, 260, 268), 80, 96, "scann_loop_backward_wide_d512"),
    (dataclasses.replace(QM9, dtype="bfloat16"), 32, 16, "scann_loop_backward_tall_d512_bf16"),
    (dataclasses.replace(MP2018, dtype="bfloat16"), 96, 32,
     "scann_loop_backward_wide_d512_bf16"),
])
def test_torch_d512_train_routes(cfm, M_, N, library):
    """A model past 256 columns trains on #4's d512 builds: QM9's recipe
    bucket (32, 16), which #2 refuses past 128 columns, and the TPU #2's
    largest bucket at D = 384 (M = 22), on the tall build; N > 16 on the
    wide one; bf16 in its own sources; the Trainer builds the route's
    library before a fit (``shape_libraries``)."""
    trainer = _trainer(cfm)
    assert kbwd.refusal(cfm, min(M_, 32), min(N, 32)) is not None
    assert trainer.train_route(M_, N) == "loop"
    assert kloop.backward_library(cfm, M_, N) == library
    assert library in trainer.shape_libraries([(M_, N, 0)], training=True)
    assert kloop.is_tall_backward(cfm, M_, N) == (N <= 16)


def _stub(monkeypatch):
    seen = []
    monkeypatch.setattr(kfwd, "call_kernel", lambda *a, **k: seen.append(a))
    monkeypatch.setattr(kloop, "max_active_clusters", lambda cfm, B, M, N, C, S=0: 15)
    return seen


@pytest.mark.parametrize("N", [16, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_d512_launch_the_backward_builds(N, dtype, monkeypatch):
    """``_launch_backward`` hands a D = 512 batch to the d512 library of its
    build and mode with its own plan (a stub in place of the CUDA library)
    and counts it (``.d512_launches`` beside ``.tall_launches`` /
    ``.wide_launches``, none in ``.d256_launches``), in each schedule, with
    the wide build's rows of one atom right after its tall scratch."""
    seen = _stub(monkeypatch)
    cfm = dataclasses.replace(_width(MP2018, 512), n_attention=1, dtype=dtype)
    x = _torch(make_synthetic_batch(np.random.default_rng(0), B=2, M=10, N=N, n_atoms=95))
    packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0)), cfm)
    y = torch.zeros(2)
    c = kloop.launch_loop_backward
    kbwd.reset_counts(c)
    for stash in (None, "f32", "bf16"):
        scratch = kloop.loop_backward_scratch(packed, cfm, 2, 10, N, stash=stash)
        assert kloop._rows_follow(scratch) if N > 16 else scratch["wide_rows"] is None
        kloop._launch_backward(packed, x, cfm, y, None, True, scratch=scratch, stash=stash)
    want = BUILDS[N] + ("_bf16" if dtype == "bfloat16" else "")
    chunk_atoms, block, _ = kloop.backward_plan(cfm, 10, N)
    for call in seen:
        assert call[:2] == (want, want)
        dims = call[4]
        assert dims[3] == 512 and dims[18] == chunk_atoms and dims[21] == block
        assert dims[23] == 8          # backward_cluster: 2 structures, 15 clusters of 8 at once
    assert [call[4][24] for call in seen] == [0, 4, 2]
    tall = N <= 16
    assert (c.launches, c.d512_launches, c.d256_launches, c.tall_launches, c.wide_launches) == (
        3, 3, 0, 3 * tall, 3 * (not tall))
    assert c.bf16_launches == 3 * (dtype == "bfloat16")
    kbwd.reset_counts(c)
    assert c.d512_launches == 0


def test_torch_d512_sharded_train_takes_the_d512_build(monkeypatch):
    """The data-parallel step (``make_sharded_loop_train`` with the launch a
    Trainer passes as its ``local``) takes the d512 build on a rank's rows,
    the wide one at N = 32 past 256 columns."""
    seen = _stub(monkeypatch)
    cfm = dataclasses.replace(MP2018, n_attention=1)
    x = _torch(make_synthetic_batch(np.random.default_rng(1), B=2, M=10, N=32, n_atoms=95))
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
    assert [call[:2] for call in seen] == [("scann_loop_backward_wide_d512",) * 2]
    assert kloop.launch_loop_backward.d512_launches == 1
    kbwd.reset_counts(kloop.launch_loop_backward)


@pytest.mark.parametrize("D", [260, 320, 384, 448, 512])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_torch_d512_training_coverage(config, D):
    """For D = G = O past 256 (4 heads at D = 260, which 8 do not divide), at
    N in {8, 12, 16, 17, 24, 32, 48, 64, 96, 128, 192, 256}: every M that
    the TPU's loop backward (``fits_loop_vmem(training=True)``) or
    molecule backward (``fits_vmem(training=True)``, N <= 32) trains gets a
    kernel route here (``Trainer.train_route`` never "per_layer"), #4's d512
    build of its N, a plan within a block and a scratch whose shapes raise
    nothing; #2 takes none of them (it keeps 128 columns)."""
    heads = 4 if D == 260 else 8
    jcfg = JaxModelConfig(**CONFIGS[config], **RECIPE, local_dim=D, global_dim=D, dense_out=D)
    jcfg = dataclasses.replace(jcfg, num_head=heads)
    cfm = _width(ModelConfig(**CONFIGS[config], **RECIPE), D, heads=heads)
    trainer = _trainer(cfm)
    loop = lambda c, M, N: jax_loop.fits_loop_vmem(c, M, N, training=True)
    fused = lambda c, M, N: N <= 32 and fits_vmem(c, M, N, training=True)
    taken = 0
    for N in (8, 12, 16, 17, 24, 32, 48, 64, 96, 128, 192, 256):
        top = max(_jax_largest_m(loop, jcfg, N, 4096), _jax_largest_m(fused, jcfg, N, 64))
        for Mx in sorted({*range(1, top + 1, max(1, top // 12)), top} - {0}):
            taken += 1
            assert trainer.train_route(Mx, N) == "loop", (config, D, N, Mx)
            assert kbwd.refusal(cfm, Mx, N) is not None
            lib = kloop.backward_library(cfm, Mx, N)
            assert lib == BUILDS[16 if N <= 16 else 24], (N, lib)
            assert kloop.backward_plan(cfm, Mx, N)[2] <= kloop.MAX_SHARED_BYTES
            assert kloop.tall_shape_for(cfm, 1, Mx, 8, True) == (8, Mx, 2 * D)
            assert (kloop.wide_rows_shape_for(cfm, 1, N, 8) is None) == (N <= 16)
    assert taken > 0 or (config, D) in {("mp2018", 512), ("ptgp", 448), ("ptgp", 512)}
