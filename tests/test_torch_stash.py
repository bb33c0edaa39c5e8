"""The activation stashes of the backward kernels #2 and #4 in the PyTorch
port against the JAX package on the CPU, at small sizes (L=2, D=32, 4 heads,
B=2, M <= 16, N=6, as ``tests/test_loop_kernels.py:636-725``).

- The mode rules: ``kloop.loop_stash_mode`` and ``kbwd.keep_acts_mode`` read
  the JAX package's switches with its defaults and meanings
  (``SCANN_TPU_LOOP_STASH``, ``SCANN_TPU_LOOP_STASH_BF16``,
  ``SCANN_TPU_UNROLL_STASH``, ``SCANN_TPU_STASH_BF16``), with "fits" the
  card's rule: the stash's bytes against ``kbwd.STASH_BUDGET_BYTES``.
- The plain bf16-stash gradients of #4 against ``loop_scann_grad(...,
  interpret=True)`` with ``loop_stash_mode`` forced to "bf16" by monkeypatch,
  as the JAX test does, and of #2 against ``fused_scann_grad(...,
  interpret=True)`` under ``SCANN_TPU_STASH_BF16=1``: SCANN and SCANN+,
  unpacked and packed, and at dropout 0.1 (attention dropout on) on the JAX
  kernels' own masks, drawn by the same calls in a small interpret-mode
  kernel and handed to the port's plain version.
  Tolerance, per gradient tensor: the mean absolute difference from JAX's
  bf16-stash gradient at most 0.1 x JAX's own bf16-stash-to-f32 mean
  difference (the statistic of ``test_torch_bf16_train.py``), or 2 x the
  f32 noise floor (the port's f32 plain gradient against JAX's f32 one) or
  1e-6 x the tensor's max where those are larger: the head's and
  embedding's gradients, which no stash rounding reaches, have a gap of 0
  and differ by f32 sums alone. The JAX kernels draw their dropout masks
  only in the TPU interpret mode (``pltpu.force_tpu_interpret_mode``, as
  ``tests/test_loop_kernels.py:479`` runs them).
- The f32 stashes compute the recompute schedule's function: the plain
  reverse walks with the f32 stash against autograd through the forward,
  each gradient within 1e-5 x its max (f32 sums in another order).
- The stash byte counts, the scratch of each mode, the recompute FLOP of
  each mode, the launchers' arguments and per-mode counts (a stub in place
  of the CUDA library), and the stash layout read from the CUDA sources.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from conftest import jit_init_vars, make_synthetic_batch
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.kernels import scann_loop as jax_loop
from scann_tpu.kernels.scann_backward import fused_scann_grad as jax_fused_grad
from scann_tpu.kernels.scann_backward import fused_scann_train_grads as jax_fused_train_grads
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu_torch.compat import params_from_jax
from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.data import packing
from scann_tpu_torch.kernels import _build
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.models.scann import init_params
from scann_tpu_torch.ops.dropout import DropoutMasks

torch.set_num_threads(1)

GAP = 0.1
NOISE = 2.0
F32_FLOOR = 1e-6     # of a tensor's max: f32 sums in another order
SMALL = dict(n_atoms=10, embedding_dim=16, n_attention=2, local_dim=32, num_head=4,
             global_dim=32, dense_out=16)
WIDE = dict(local_dim=128, num_head=8, global_dim=128, dense_out=128, scale=0.5,
            use_attn_norm=True, use_ga_norm=True)
MP2018 = ModelConfig(n_atoms=95, embedding_dim=128, n_attention=9, g_update=True,
                     gaussian_d=6.0, **WIDE)
PTGP = ModelConfig(n_atoms=80, embedding_dim=48, n_attention=11, use_ring=True,
                   g_update=False, gaussian_d=4.0, **WIDE)
QM9 = ModelConfig(n_atoms=10, embedding_dim=48, n_attention=7, g_update=True,
                  gaussian_d=4.0, **WIDE)
SWITCHES = ("SCANN_TPU_LOOP_STASH", "SCANN_TPU_LOOP_STASH_BF16", "SCANN_TPU_UNROLL_STASH",
            "SCANN_TPU_STASH_BF16")


@pytest.fixture
def clean_env(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


# --- the mode rules ------------------------------------------------------------------

def test_torch_loop_stash_mode_takes_f32_at_every_published_shape(clean_env):
    """With no switch set the f32 selective stash at MP2018 (64, 96, 32), its
    batch of 128 and Pt/graphene (64, 128, 32), as the JAX package's
    ``loop_stash_mode`` picks it at the MP2018 bucket (96, 32)."""
    jmp = JaxModelConfig(n_atoms=95, embedding_dim=128, n_attention=9, local_dim=128,
                         num_head=8, global_dim=128, dense_out=128, g_update=True)
    assert jax_loop.loop_stash_mode(jmp, 96, 32) == "f32"
    for cfm, shape in ((MP2018, (64, 96, 32)), (MP2018, (128, 96, 32)), (PTGP, (64, 128, 32))):
        assert kloop.loop_stash_mode(cfm, *shape) == "f32", shape
        assert kloop.loop_stash_bytes(cfm, *shape, "f32") <= kbwd.STASH_BUDGET_BYTES
    # Pt/graphene at B=128 does not fit the budget in f32: exact recompute by default
    assert kloop.loop_stash_mode(PTGP, 128, 128, 32) is None


@pytest.mark.parametrize("bf16_switch", ["0", "1"])
def test_torch_loop_stash_mode_switches(clean_env, bf16_switch):
    """``"bf16"`` only where the f32 stash does not fit, the halved one does
    and ``SCANN_TPU_LOOP_STASH_BF16=1`` (``scann_loop.py:165-183``); f32 stays
    preferred where it fits; ``SCANN_TPU_LOOP_STASH=0`` gives None even with
    the bf16 switch set; a budget below the bf16 stash gives None."""
    clean_env.setenv("SCANN_TPU_LOOP_STASH_BF16", bf16_switch)
    shape = (64, 96, 32)
    f32 = kloop.loop_stash_bytes(MP2018, *shape, "f32")
    half = kloop.loop_stash_bytes(MP2018, *shape, "bf16")
    assert half < f32
    default = kbwd.STASH_BUDGET_BYTES
    budget = lambda b: clean_env.setattr(kbwd, "STASH_BUDGET_BYTES", b)
    budget(f32)
    assert kloop.loop_stash_mode(MP2018, *shape) == "f32"
    budget(f32 - 1)
    assert kloop.loop_stash_mode(MP2018, *shape) == ("bf16" if bf16_switch == "1" else None)
    budget(half - 1)
    assert kloop.loop_stash_mode(MP2018, *shape) is None
    budget(default)
    assert kloop.loop_stash_mode(PTGP, 128, 128, 32) == ("bf16" if bf16_switch == "1" else None)
    clean_env.setenv("SCANN_TPU_LOOP_STASH", "0")
    assert kloop.loop_stash_mode(MP2018, *shape) is None
    budget(f32 - 1)
    assert kloop.loop_stash_mode(MP2018, *shape) is None


def test_torch_keep_acts_mode_switches(clean_env):
    """#2's keep-acts stash: f32 at QM9 (128, 32, 16) by default;
    ``SCANN_TPU_STASH_BF16=1`` makes it bf16 unconditionally, where the f32
    stash fits too (``scann_backward.py:264``, unlike the loop kernel's
    switch); ``SCANN_TPU_UNROLL_STASH=0`` forces the recompute schedule; a
    stash over the budget gives None."""
    shape = (128, 32, 16)
    assert kbwd.keep_acts_mode(QM9, *shape) == "f32"
    f32 = kbwd.keep_acts_stash_bytes(QM9, *shape, "f32")
    half = kbwd.keep_acts_stash_bytes(QM9, *shape, "bf16")
    assert half < f32 <= kbwd.STASH_BUDGET_BYTES
    default = kbwd.STASH_BUDGET_BYTES
    budget = lambda b: clean_env.setattr(kbwd, "STASH_BUDGET_BYTES", b)
    budget(f32 - 1)
    assert kbwd.keep_acts_mode(QM9, *shape) is None
    clean_env.setenv("SCANN_TPU_STASH_BF16", "1")
    assert kbwd.keep_acts_mode(QM9, *shape) == "bf16"
    budget(half - 1)
    assert kbwd.keep_acts_mode(QM9, *shape) is None
    budget(default)
    assert kbwd.keep_acts_mode(QM9, *shape) == "bf16"
    clean_env.setenv("SCANN_TPU_UNROLL_STASH", "0")
    assert kbwd.keep_acts_mode(QM9, *shape) is None


# --- the stash's bytes, scratch and recompute -------------------------------------------

@pytest.mark.parametrize("g_update", [True, False])
@pytest.mark.parametrize("mode", [None, "f32", "bf16"])
def test_torch_stash_bytes_and_scratch_shapes(g_update, mode):
    """Each ``*_stash_bytes`` is the bytes of the stash tensors that the
    scratch of that mode holds, which have the CUDA sources' layouts; the
    recompute schedule's scratch holds none."""
    cfm = ModelConfig(**SMALL, g_update=g_update)
    B, M, N = 2, 12, 6
    L, D, H, R = 2, 32, 4, M * N
    big = torch.bfloat16 if mode == "bf16" else torch.float32
    nbytes = lambda d: sum(t.numel() * t.element_size() for t in d.values() if t is not None)

    keep = kbwd.keep_acts_scratch(cfm, B, M, N, mode, "cpu")
    assert nbytes(keep) == kbwd.keep_acts_stash_bytes(cfm, B, M, N, mode)
    loop = kloop.loop_stash_scratch(cfm, B, M, N, mode, "cpu")
    assert nbytes(loop) == kloop.loop_stash_bytes(cfm, B, M, N, mode)
    if mode is None:
        assert all(v is None for v in (*keep.values(), *loop.values()))
        return
    shapes = lambda d: {k: (tuple(v.shape), v.dtype) for k, v in d.items() if v is not None}
    want = {"stash_rows": ((B, L, 5 if g_update else 4, R, D), big),
            "stash_attn": ((B, L, R, H), torch.float32),
            "stash_atoms": ((B, L, 6, M, D), torch.float32),
            "stash_inv": ((B, L, 2, M), torch.float32)}
    if g_update:
        want["stash_ginv"] = ((B, L, R), torch.float32)
    assert shapes(keep) == want
    want = {"stash_rows": ((B, L, 3, R, D), big), "stash_attn": ((B, L, R, H), big)}
    if mode == "bf16":
        want["stash_o1"] = ((B, L, M, D), torch.float32)
    assert shapes(loop) == want


def test_torch_stash_recompute_flops():
    """Under the stash ``recompute_flops`` counts only what is formed again
    outside the layers (the readout, the embeddings) and
    ``loop_recompute_flops`` a layer's three [M, D] products (query, the
    ResidualNorm's two) and, in the bf16 stash, its rebuilt context."""
    B, M, N = 64, 96, 32
    L, D, R = MP2018.n_attention, MP2018.local_dim, M * N
    mm = lambda rows, k, n: 2 * rows * k * n
    per_layer = (4 * mm(M, D, D) + mm(R, 2 * D, D) + mm(R, D, D) + 2 * R * D)
    full = kloop.loop_recompute_flops(MP2018, B, M, N)
    assert full == kloop.loop_recompute_flops(MP2018, B, M, N, None)
    outside = full - B * L * per_layer
    assert kloop.loop_recompute_flops(MP2018, B, M, N, "f32") == outside + B * L * 3 * mm(M, D, D)
    assert (kloop.loop_recompute_flops(MP2018, B, M, N, "bf16")
            == outside + B * L * (3 * mm(M, D, D) + 2 * R * D))
    B, M, N = 128, 32, 16
    R = M * N
    per_layer = 4 * mm(M, D, D) + mm(R, 2 * D, D) + mm(R, D, D) + 2 * R * D
    full = kbwd.recompute_flops(QM9, B, M, N)
    assert kbwd.recompute_flops(QM9, B, M, N, "f32") == kbwd.recompute_flops(QM9, B, M, N, "bf16")
    assert kbwd.recompute_flops(QM9, B, M, N, "f32") == full - B * QM9.n_attention * per_layer
    assert 0 < kbwd.recompute_flops(QM9, B, M, N, "f32") < full / 10


def test_torch_stash_layout_matches_cuda_sources():
    """The scratch layouts and launch arguments above are the ones the CUDA
    sources index: the row slots, the per-atom slots, the pointers and the
    size that carries the stash's element bytes."""
    src = {n: open(_build.source_files(n)[0]).read()
           for n in ("scann_backward", "scann_loop_backward")}
    loop, mol = src["scann_loop_backward"], src["scann_backward"]
    assert "return ((size_t)b * L + l) * 3 + k;" in loop            # ns, u_pre, key
    assert "a.stash = dims[24];" in loop and "a.st_rows = ptrs[56];" in loop
    assert "a.st_attn = ptrs[57];" in loop and "a.st_atoms = (float*)ptrs[58];" in loop
    assert "const int nk = a.g_update ? 5 : 4;" in mol
    assert "(((size_t)b * L + l) * 6 + k) * M * D" in mol and "(((size_t)b * L + l) * 2 + k) * M" in mol
    assert "a.stash = dims[22];" in mol
    for i, name in enumerate(("st_rows", "st_attn", "st_ginv", "st_atoms", "st_inv")):
        assert f"a.{name} = " in mol and f"ptrs[{55 + i}];" in mol
    common = open(_build.source_files("scann_backward")[0].replace(
        "scann_backward.cu", "scann_grad_common.cuh")).read()
    assert "__floats2bfloat162_rn" in common and "__float2bfloat16_rn" in common
    assert [kbwd.stash_element_bytes(m) for m in (None, "f32", "bf16")] == [0, 4, 2]


def _stub_launches(monkeypatch):
    calls = []

    def stub(library, symbol, dev, tensors, dims, *args):
        calls.append((symbol, list(tensors), list(dims)))

    monkeypatch.setattr(kfwd, "call_kernel", stub)
    monkeypatch.setattr(kbwd, "call_kernel", stub)
    return calls


@pytest.mark.parametrize("kernel", [2, 4])
def test_torch_stash_launch_arguments_and_counts(kernel, clean_env):
    """A launch passes its mode's stash (the rule's by default) and its
    element bytes, and each launcher counts launches per mode beside
    ``.launches`` / ``.bf16_launches``; a kept loop scratch of another mode
    raises, and nothing falls back."""
    calls = _stub_launches(clean_env)
    cfm = ModelConfig(**SMALL, g_update=True)
    x = {k: torch.from_numpy(np.asarray(v)) for k, v in
         make_synthetic_batch(np.random.default_rng(0), B=2, M=12, N=6).items()}
    packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0), "cpu"), cfm)
    y = torch.zeros(2, 1)
    launcher = kbwd.launch_scann_backward if kernel == 2 else kloop.launch_loop_backward
    kbwd.reset_counts(launcher)

    def launch(stash=kbwd.AUTO, scratch=None):
        if kernel == 2:
            return kbwd._launch(packed, x, cfm, y, None, True, stash=stash)
        return kloop._launch_backward(packed, x, cfm, y, None, True, scratch=scratch,
                                      stash=stash)

    for stash in (kbwd.AUTO, None, "f32", "bf16"):
        launch(stash)
    # #4 passes its wide key scratch last: None at a narrow N
    n_ptr, bytes_at = (60, 22) if kernel == 2 else (60, 24)
    assert [len(c[1]) for c in calls] == [n_ptr] * 4
    assert [c[2][bytes_at] for c in calls] == [4, 0, 4, 2]
    rows = [c[1][n_ptr - (5 if kernel == 2 else 4)] for c in calls]
    if kernel == 4:
        assert all(c[1][-1] is None for c in calls)
    assert rows[1] is None and rows[0].dtype == rows[2].dtype == torch.float32
    assert rows[3].dtype == torch.bfloat16
    assert (launcher.launches, launcher.stash_launches, launcher.bf16_stash_launches) == (4, 2, 1)
    assert launcher.bf16_launches == 0
    if kernel == 4:
        kept = kloop.loop_backward_scratch(packed, cfm, 2, 12, 6, stash="f32")
        assert kloop.scratch_stash_mode(kept) == "f32"
        with pytest.raises(ValueError, match="stash"):
            launch("bf16", kept)
        clean_env.setenv("SCANN_TPU_LOOP_STASH", "0")
        with pytest.raises(ValueError, match="stash"):
            launch(kbwd.AUTO, kept)
    with pytest.raises(ValueError, match="stash="):
        launch("f16")
    kbwd.reset_counts(launcher)


# --- the f32 stashes compute the recompute schedule's function ----------------------------

def _small_case(seed, B=2, M=12, N=6, packed=False, **kw):
    cfm = ModelConfig(**SMALL, **kw)
    rng = np.random.default_rng(seed)
    if packed:
        x = make_synthetic_batch(rng, B=4 * B, M=M // 2, N=N, use_ring=cfm.use_ring)
        p = packing.pack_padded_inputs(x, capacity=M, max_segments=3)
        x = {k: np.ascontiguousarray(v[:B]) for k, v in p.inputs.items() if k != "segment_mask"}
    else:
        x = make_synthetic_batch(rng, B=B, M=M, N=N, use_ring=cfm.use_ring)
    tx = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}
    return cfm, x, tx


@pytest.mark.parametrize("kw", [dict(g_update=True), dict(g_update=False, use_ring=True),
                                dict(g_update=True, use_drop=True, packed=True),
                                dict(g_update=True, dtype="bfloat16")],
                         ids=["scann+", "scann-ring", "scann+-drop-packed", "scann+-bf16"])
def test_torch_f32_stash_walks_equal_autograd(kw):
    """The plain reverse walks on the f32 stashes (``kbwd.reference_stash_*``
    with the keep-acts stash, ``kloop.reference_loop_stash_*`` with the
    selective stash's rebuild) against autograd through the training forward
    (the recompute schedule's plain version), one-shot at dropout 0.1 and
    with a GA cotangent: each gradient within 1e-5 x its max (f32 sums in
    another order); in the bf16 operand mode, where one flipped rounding
    moves a whole small batch, within 2e-3 x."""
    cfm, _, x = _small_case(3, **kw)
    p = init_params(cfm, torch.Generator().manual_seed(1), "cpu")
    B, M = x["atomic"].shape[:2]
    S = max(kfwd.segment_count(x), 1)
    g = torch.Generator().manual_seed(2)
    y, ctp, ctg = torch.randn(B, S, generator=g), torch.randn(B, S, generator=g), \
        torch.randn(B, M, 1, generator=g)
    tol = 2e-3 if cfm.dtype == "bfloat16" else 1e-5
    close = lambda a, b: all(float((a[k] - b[k]).abs().max()) <= tol * float(b[k].abs().max())
                             + 1e-12 for k in b)
    pred0, want = kbwd.reference_fused_scann_train_grads(p, x, y, cfm, False, 0.1, 5)
    pred1, got = kbwd.reference_stash_train_grads(p, x, y, cfm, False, 0.1, 5, mode="f32")
    assert torch.allclose(pred1, pred0, rtol=1e-6, atol=1e-7) and close(got, want)
    pred0, want = kloop.reference_loop_train_grads(p, x, y, cfm, False, 0.1, 5)
    pred1, got = kloop.reference_loop_stash_train_grads(p, x, y, cfm, False, 0.1, 5, mode="f32")
    assert torch.allclose(pred1, pred0, rtol=1e-6, atol=1e-7) and close(got, want)
    want = kbwd.reference_fused_scann_grad(p, x, cfm, ctp, ctg, 0.1, 5)
    assert close(kbwd.reference_stash_grad(p, x, cfm, ctp, ctg, 0.1, 5, mode="f32"), want)
    want = kloop.reference_loop_grad(p, x, cfm, ctp, ctg, 0.1, 5)
    assert close(kloop.reference_loop_stash_grad(p, x, cfm, ctp, ctg, 0.1, 5, mode="f32"), want)


def test_torch_bf16_stash_dispatch_on_the_cpu(clean_env, monkeypatch):
    """The public entry points on CPU tensors run the plain version of the
    schedule the mode rule picks: the bf16 stash's reverse walk where it
    says "bf16", the recompute schedule's function otherwise."""
    cfm, _, x = _small_case(4, g_update=True)
    p = init_params(cfm, torch.Generator().manual_seed(1), "cpu")
    y = torch.randn(2, 1, generator=torch.Generator().manual_seed(3))
    same = lambda a, b: all(torch.equal(a[k], b[k]) for k in b)
    assert same(kbwd.fused_scann_train_grads(p, x, y, cfm)[1],
                kbwd.reference_fused_scann_train_grads(p, x, y, cfm)[1])
    clean_env.setenv("SCANN_TPU_STASH_BF16", "1")
    assert same(kbwd.fused_scann_train_grads(p, x, y, cfm)[1],
                kbwd.reference_stash_train_grads(p, x, y, cfm, mode="bf16")[1])
    monkeypatch.setattr(kloop, "loop_stash_mode", lambda *a, **k: "bf16")
    assert same(kloop.loop_scann_train_grads(p, x, y, cfm)[1],
                kloop.reference_loop_stash_train_grads(p, x, y, cfm, mode="bf16")[1])
    ct = (torch.ones(2, 1), torch.zeros(2, 12, 1))
    assert same(kloop.loop_scann_grad(p, x, cfm, *ct),
                kloop.reference_loop_stash_grad(p, x, cfm, *ct, mode="bf16"))


# --- the bf16 stashes against the JAX kernels -----------------------------------------------

def _jax_masks(kind, seed, B, M, N, cfm, rate):
    """The dropout masks the JAX backward kernel ``kind`` ("molecule": #2,
    ``make_dropout_masks``; "loop": #4, ``_bwd_kernel``'s draws and
    ``_make_attn_mask``) draws for molecules 0..B-1 at ``seed``, by the same
    calls in a small interpret-mode kernel, as the port's DropoutMasks."""
    from scann_tpu.config import attn_dropout_rate
    from scann_tpu.kernels.scann_forward import make_dropout_masks

    L, D, H = cfm.n_attention, cfm.local_dim, cfm.num_head
    attn_rate = attn_dropout_rate(cfm, rate)

    def kernel(seed_ref, e_ref, l_ref, a_ref):
        b = pl.program_id(0)
        if kind == "molecule":
            em, lm, atm = make_dropout_masks(seed_ref[0, 0], b, 1, M, D, L, rate, n=N, h=H,
                                             attn_rate=attn_rate)
        else:
            pltpu.prng_seed(seed_ref[0, 0] + b)
            keep = jnp.uint32(int((1.0 - rate) * (2 ** 32 - 1)))
            draw = lambda: ((pltpu.bitcast(pltpu.prng_random_bits((M, D)), jnp.uint32) < keep)
                            .astype(jnp.float32) * jnp.float32(1.0 / (1.0 - rate)))
            em = draw()
            lm = [draw() for _ in range(L)]
            attn_mask = jax_loop._make_attn_mask(seed_ref[0, 0] + b, M, N, H, attn_rate)
            atm = [attn_mask(l) for l in range(L)]
        e_ref[0] = em
        for l in range(L):
            l_ref[0, l] = lm[l]
            a_ref[0, l] = atm[l]

    spec = lambda shape: pl.BlockSpec((1,) + shape, lambda b: (b,) + (0,) * len(shape),
                                      memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        e, lay, att = pl.pallas_call(
            kernel, grid=(B,),
            in_specs=[pl.BlockSpec((1, 1), lambda b: (0, 0), memory_space=pltpu.VMEM)],
            out_specs=[spec((M, D)), spec((L, M, D)), spec((L, M, N, H))],
            out_shape=[jax.ShapeDtypeStruct((B, M, D), jnp.float32),
                       jax.ShapeDtypeStruct((B, L, M, D), jnp.float32),
                       jax.ShapeDtypeStruct((B, L, M, N, H), jnp.float32)],
            )(jnp.full((1, 1), seed, jnp.int32))
    t = lambda a: torch.from_numpy(np.array(a))
    return DropoutMasks(t(e), [t(lay[:, l]) for l in range(L)],
                        [t(att[:, l]) for l in range(L)])


@contextlib.contextmanager
def _interpreted(rate):
    """How the JAX kernels run here: in the TPU interpret mode where they
    draw dropout masks, else ``interpret=True``; yields the ``interpret``
    argument."""
    if rate:
        with pltpu.force_tpu_interpret_mode():
            yield False
    else:
        yield True


def _setup(seed, packed, dropout, g_update):
    """(JAX config, port config, JAX params, port params, numpy inputs, torch
    inputs) at B=2, M=16, N=6 (packed: two slots of 16 rows, S=4 with empty
    segments)."""
    kw = dict(g_update=g_update, use_drop=dropout, use_ring=not g_update)
    jcfg = JaxModelConfig(**SMALL, **kw)
    tcfg = ModelConfig(**SMALL, **kw)
    rng = np.random.default_rng(seed)
    if packed:
        x = make_synthetic_batch(rng, B=8, M=8, N=6, use_ring=tcfg.use_ring)
        p = packing.pack_padded_inputs(x, capacity=16, max_segments=3)
        x = {k: np.ascontiguousarray(v[:2]) for k, v in p.inputs.items() if k != "segment_mask"}
        seg = x["segment_onehot"]        # widened to S=4: every slot has an empty segment
        x["segment_onehot"] = np.concatenate(
            [seg, np.zeros(seg.shape[:2] + (4 - seg.shape[2],), np.float32)], -1)
    else:
        x = make_synthetic_batch(rng, B=2, M=16, N=6, use_ring=tcfg.use_ring)
    jparams = jax.device_get(jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(seed),
                                           x))
    tx = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}
    return jcfg, tcfg, jparams, params_from_jax(jparams, tcfg), x, tx


def _flat(grads):
    """Per-tensor f64 arrays of a gradient dict (the port's) or tree (JAX's),
    keyed alike."""
    if not all(isinstance(v, torch.Tensor) for v in grads.values()):
        grads = {"/".join(p.key for p in path): np.asarray(v)
                 for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return {k: np.asarray(v, np.float64) for k, v in grads.items()}


def _hold(p16, p32, j16, j32, label):
    """The per-tensor hold of the module docstring."""
    p16, p32, j16, j32 = map(_flat, (p16, p32, j16, j32))
    assert sorted(p16) == sorted(j16) == sorted(j32) == sorted(p32)
    worst, reached = 0.0, 0
    for k in sorted(j16):
        assert np.isfinite(p16[k]).all(), k
        gap = np.abs(j16[k] - j32[k]).mean()
        noise = np.abs(p32[k] - j32[k]).mean()
        dist = np.abs(p16[k] - j16[k]).mean()
        limit = max(GAP * gap, NOISE * noise, F32_FLOOR * np.abs(j32[k]).max())
        assert dist <= limit, (label, k, dist, gap, noise)
        if GAP * gap == limit:
            reached += 1
            worst = max(worst, dist / gap)
    print(f"{label}: worst |port - JAX| / JAX's bf16-stash gap {worst:.4f} over {reached} "
          f"tensors the stash rounding moves")
    assert reached >= 4, reached       # the stash's rounding reaches the layers' gradients


CASES = [(g, variant) for g in (True, False) for variant in ("plain", "packed", "dropout")]
CASE_IDS = [f"{'scann+' if g else 'scann'}-{v}" for g, v in CASES]


@pytest.mark.parametrize("g_update,variant", CASES, ids=CASE_IDS)
def test_torch_loop_bf16_stash_grads_match_jax_kernel(g_update, variant, monkeypatch):
    """#4's plain bf16 selective stash (``kloop.reference_loop_stash_*``)
    against ``loop_scann_train_grads`` / ``loop_scann_grad(...,
    interpret=True)`` with ``loop_stash_mode`` forced to "bf16", as
    ``tests/test_loop_kernels.py:710`` forces it; JAX's gap is its bf16
    stash against its f32 one (``SCANN_TPU_LOOP_STASH`` on, the f32 mode)."""
    jcfg, tcfg, jp, tp, x, tx = _setup(11, variant == "packed", variant == "dropout", g_update)
    B = x["atomic"].shape[0]
    S = 4 if variant == "packed" else 1
    rate = 0.1 if variant == "dropout" else 0.0
    rng = np.random.default_rng(5)
    y = rng.normal(size=(B, S)).astype(np.float32)
    ct = (rng.normal(size=(B, 1)).astype(np.float32), rng.normal(size=(B, 16, 1)).astype(np.float32))
    if rate:
        masks = _jax_masks("loop", 42, B, 16, 6, tcfg, rate)
        monkeypatch.setattr(kbwd, "dropout_masks_for", lambda *a, **k: masks)
    want = {}
    for mode in ("bf16", "f32"):
        monkeypatch.setattr(jax_loop, "loop_stash_mode", lambda *a, mode=mode, **k: mode)
        with _interpreted(rate) as interpret:
            want[mode] = (jax_loop.loop_scann_train_grads(jp, x, y, jcfg, interpret=interpret,
                                                          dropout_rate=rate, dropout_seed=42),
                          None if S > 1 else jax_loop.loop_scann_grad(
                              jp, x, jcfg, *ct, interpret=interpret, dropout_rate=rate,
                              dropout_seed=42))
    pred16, p16 = kloop.reference_loop_stash_train_grads(tp, tx, torch.from_numpy(y), tcfg,
                                                         dropout_rate=rate, dropout_seed=42)
    _, p32 = kloop.reference_loop_train_grads(tp, tx, torch.from_numpy(y), tcfg,
                                              dropout_rate=rate, dropout_seed=42)
    np.testing.assert_allclose(pred16.numpy(), np.asarray(want["bf16"][0][0]).reshape(B, -1),
                               rtol=1e-4, atol=1e-5)
    _hold(p16, p32, want["bf16"][0][1], want["f32"][0][1], f"#4 {CASE_IDS[CASES.index((g_update, variant))]}")
    if S == 1:
        ctp, ctg = map(torch.from_numpy, ct)
        _hold(kloop.reference_loop_stash_grad(tp, tx, tcfg, ctp, ctg, rate, 42),
              kloop.reference_loop_grad(tp, tx, tcfg, ctp, ctg, rate, 42),
              want["bf16"][1], want["f32"][1], "#4 cotangent")


@pytest.mark.parametrize("g_update,variant", CASES, ids=CASE_IDS)
def test_torch_keep_acts_bf16_stash_grads_match_jax_kernel(g_update, variant, monkeypatch):
    """#2's plain bf16 keep-acts stash (``kbwd.reference_stash_*``: the five
    row tensors of ``_BF16_KEYS`` rounded, the rest kept in f32) against
    ``fused_scann_train_grads`` / ``fused_scann_grad(..., interpret=True,
    batch_tile=1)`` under ``SCANN_TPU_STASH_BF16=1``; JAX's gap is that
    against the same call under ``SCANN_TPU_STASH_BF16=0``."""
    jcfg, tcfg, jp, tp, x, tx = _setup(12, variant == "packed", variant == "dropout", g_update)
    B = x["atomic"].shape[0]
    S = 4 if variant == "packed" else 1
    rate = 0.1 if variant == "dropout" else 0.0
    rng = np.random.default_rng(6)
    y = rng.normal(size=(B, S)).astype(np.float32)
    ct = (rng.normal(size=(B, S)).astype(np.float32), rng.normal(size=(B, 16, 1)).astype(np.float32))
    if rate:
        masks = _jax_masks("molecule", 42, B, 16, 6, tcfg, rate)
        monkeypatch.setattr(kbwd, "dropout_masks_for", lambda *a, **k: masks)
    monkeypatch.setenv("SCANN_TPU_UNROLL_STASH", "1")
    want = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("SCANN_TPU_STASH_BF16", flag)
        with _interpreted(rate) as interpret:
            want[flag] = (jax_fused_train_grads(jp, x, y, jcfg, interpret=interpret,
                                                dropout_rate=rate, dropout_seed=42, batch_tile=1),
                          jax_fused_grad(jp, x, jcfg, *ct, interpret=interpret,
                                         dropout_rate=rate, dropout_seed=42, batch_tile=1))
    pred16, p16 = kbwd.reference_stash_train_grads(tp, tx, torch.from_numpy(y), tcfg,
                                                   dropout_rate=rate, seed=42)
    _, p32 = kbwd.reference_fused_scann_train_grads(tp, tx, torch.from_numpy(y), tcfg,
                                                    dropout_rate=rate, seed=42)
    np.testing.assert_allclose(pred16.numpy(), np.asarray(want["1"][0][0]).reshape(B, -1),
                               rtol=1e-4, atol=1e-5)
    label = f"#2 {CASE_IDS[CASES.index((g_update, variant))]}"
    _hold(p16, p32, want["1"][0][1], want["0"][0][1], label)
    ctp, ctg = map(torch.from_numpy, ct)
    _hold(kbwd.reference_stash_grad(tp, tx, tcfg, ctp, ctg, rate, 42),
          kbwd.reference_fused_scann_grad(tp, tx, tcfg, ctp, ctg, rate, 42),
          want["1"][1], want["0"][1], label + " cotangent")


def test_torch_bf16_stash_reference_differs_from_f32():
    """What a port that ignored the bf16 stash would read: the plain
    bf16-stash gradients differ from the f32 ones in every layer weight the
    stash's rounding reaches, and the two stashes round differently (#2 keeps
    attention in f32 and rounds geo_term; #4 rounds attention and rebuilds
    geo_term)."""
    cfm, _, x = _small_case(7, g_update=True)
    p = init_params(cfm, torch.Generator().manual_seed(1), "cpu")
    y = torch.randn(2, 1, generator=torch.Generator().manual_seed(3))
    _, f32 = kbwd.reference_fused_scann_train_grads(p, x, y, cfm)
    _, mol = kbwd.reference_stash_train_grads(p, x, y, cfm, mode="bf16")
    _, loop = kloop.reference_loop_stash_train_grads(p, x, y, cfm, mode="bf16")
    key = "local_attention_0/key/kernel"
    assert not torch.equal(mol[key], f32[key]) and not torch.equal(loop[key], f32[key])
    assert not torch.equal(mol[key], loop[key])
    head = "predict_property/kernel"        # no stash rounding reaches the head: f32 sums
    assert torch.allclose(mol[head], f32[head], rtol=1e-5, atol=1e-6)


# --- the gates of the backward kernels against the TPU kernels' ------------------------

GATE_N = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256)
GATE_M = 1024      # past the TPU gates' largest edge, 968 (Pt/graphene at N = 8)
# the largest M (up to GATE_M) that each gate takes at each N, for QM9, MP2018
# and Pt/graphene (configs/model_*.yaml): the TPU's loop backward (#4,
# fits_loop_vmem training) and loop forward (#3, fits_loop_vmem eval), the
# port's #4 (backward_refusal), #3 (refusal) and #2 (kbwd.refusal). The port's
# loop kernels take N up to 256 in their wide builds (N > 32 for #4, N > 64
# for #3); both wide builds keep their centers in global memory, as the tall
# builds do at a narrower N, and take M into the thousands
PORT4 = (1024,) * 10
PORT3 = (1024,) * 10
PORT2 = (33, 33, 33, 33, 0, 0, 0, 0, 0, 0)
TPU = {"qm9": (828, 467, 325, 254, 170, 128, 88, 66, 44, 33),
       "mp2018": (768, 428, 298, 232, 156, 121, 81, 61, 40, 30),
       "ptgp": (968, 573, 407, 322, 228, 172, 121, 91, 61, 45)}
GATES = {name: {"tpu4": t, "port4": PORT4, "tpu3": t, "port3": PORT3, "port2": PORT2}
         for name, t in TPU.items()}


@pytest.mark.parametrize("name", sorted(GATES))
def test_torch_backward_gates_against_the_tpu_kernels(name):
    """The table of ``ROADMAP.md`` §B1: where the port's whole-model kernels
    stop (N <= 32 for #2, N <= 256 for #3 and #4 in their wide builds, M
    into the thousands in their tall and wide builds) and where the TPU kernels' VMEM
    gates stop, at each published config's widths; the port's loop kernels
    take every M the TPU's take at every N."""
    jax_kw = dict(local_dim=128, num_head=8, global_dim=128, dense_out=128, scale=0.5,
                  use_attn_norm=True, use_ga_norm=True)
    kw = {"qm9": dict(n_atoms=10, embedding_dim=48, n_attention=7, g_update=True,
                      gaussian_d=4.0),
          "mp2018": dict(n_atoms=95, embedding_dim=128, n_attention=9, g_update=True,
                         gaussian_d=6.0),
          "ptgp": dict(n_atoms=80, embedding_dim=48, n_attention=11, use_ring=True,
                       g_update=False, gaussian_d=4.0)}[name]
    jcfg, tcfg = JaxModelConfig(**kw, **jax_kw), ModelConfig(**kw, **jax_kw)

    def largest(ok):
        return max([M for M in range(1, GATE_M + 1) if ok(M)], default=0)

    got = {
        "tpu4": tuple(largest(lambda M: jax_loop.fits_loop_vmem(jcfg, M, N, training=True))
                      for N in GATE_N),
        "port4": tuple(largest(lambda M: kloop.backward_refusal(tcfg, M, N) is None)
                       for N in GATE_N),
        "tpu3": tuple(largest(lambda M: jax_loop.fits_loop_vmem(jcfg, M, N, training=False))
                      for N in GATE_N),
        "port3": tuple(largest(lambda M: kloop.refusal(tcfg, M, N) is None) for N in GATE_N),
        "port2": tuple(largest(lambda M: kbwd.refusal(tcfg, M, N) is None) for N in GATE_N),
    }
    print(name, {k: dict(zip(GATE_N, v)) for k, v in got.items()})
    assert got == GATES[name]
    # the search reaches past every TPU edge, and at every N the port's loop
    # kernels take every M the TPU's take
    assert max(got["tpu3"] + got["tpu4"]) < GATE_M
    for i, N in enumerate(GATE_N):
        assert got["port3"][i] >= got["tpu3"][i] and got["port4"][i] >= got["tpu4"][i], N
