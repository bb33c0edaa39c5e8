"""The PyTorch port's backward-kernel wrapper on the CPU (its plain version)
against the JAX package's whole-model backward kernel, run in interpret
mode with ``batch_tile=1``, in float32: the same flax parameters (moved with
``params_from_jax``) and the same seeded inputs
(``conftest.make_synthetic_batch``). Gradients are held per tensor at atol
2e-5 x max |reference|, as ``tests/test_kernels.py:315-319`` holds the
Pallas kernel."""

import jax
import numpy as np
import pytest
import torch

from conftest import jit_init_vars, make_synthetic_batch
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.kernels.scann_backward import fused_scann_grad as jax_fused_grad
from scann_tpu.kernels.scann_backward import fused_scann_train_grads as jax_train_grads
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu_torch.compat import params_from_jax
from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.kernels import _build
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.models.scann import param_shapes, scann_forward
from scann_tpu_torch.ops.dropout import make_dropout_masks

torch.set_num_threads(1)

GRAD_TOL = 2e-5
SMALL = dict(n_atoms=10, embedding_dim=16, n_attention=2, local_dim=32,
             num_head=4, global_dim=32, dense_out=16)
GRID = [  # (g_update, ga_norm, mrelu, ring, cgcnn), as in test_torch_model.py
    (True, True, False, False, False),
    (False, False, True, False, False),
    (True, False, False, False, False),
    (False, True, False, True, False),
    (True, True, False, False, True),
    (True, True, False, True, False),
]


def _setup(seed, mrelu=False, B=3, M=12, N=6, **kw):
    jcfg, tcfg = JaxModelConfig(**SMALL, **kw), ModelConfig(**SMALL, **kw)
    inputs = make_synthetic_batch(np.random.default_rng(seed), B=B, M=M, N=N,
                                  use_ring=tcfg.use_ring, cgcnn=tcfg.feature == "cgcnn")
    jparams = jit_init_vars(JaxScannModel(config=jcfg, mrelu_head=mrelu),
                            jax.random.PRNGKey(0), inputs)
    tparams = params_from_jax(jax.device_get(jparams), tcfg)
    tinputs = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    return jcfg, tcfg, jparams, tparams, inputs, tinputs


def _flat(tree):
    return {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_grads(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                                   atol=GRAD_TOL * (np.abs(w).max() + 1e-8),
                                   err_msg=f"gradient of {k}")


@pytest.mark.parametrize("g_update,ga_norm,mrelu,ring,cgcnn", GRID)
def test_torch_train_grads_match_jax_kernel(g_update, ga_norm, mrelu, ring, cgcnn):
    jcfg, tcfg, jparams, tparams, inputs, tinputs = _setup(
        1, mrelu=mrelu, g_update=g_update, use_ga_norm=ga_norm, use_ring=ring,
        feature="cgcnn" if cgcnn else "atomic")
    y = np.linspace(-1, 1, 3, dtype=np.float32)
    jpred, jraw = jax_train_grads(jparams, inputs, y, jcfg, mrelu_head=mrelu,
                                  interpret=True, batch_tile=1)
    pred, raw = kbwd.fused_scann_train_grads(tparams, tinputs, torch.from_numpy(y), tcfg, mrelu)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5, atol=1e-6)
    _assert_grads(raw, _flat(jraw))


@pytest.mark.parametrize("g_update", [True, False])
def test_torch_grad_with_ga_cotangent_matches_jax_kernel(g_update):
    jcfg, tcfg, jparams, tparams, inputs, tinputs = _setup(2, g_update=g_update)
    rng = np.random.default_rng(3)
    ct_pred = rng.normal(size=(3, 1)).astype(np.float32)
    ct_ga = rng.normal(size=(3, 12, 1)).astype(np.float32)
    jg = jax_fused_grad(jparams, inputs, jcfg, ct_pred, ct_ga, interpret=True, batch_tile=1)
    g = kbwd.fused_scann_grad(tparams, tinputs, tcfg, torch.from_numpy(ct_pred),
                              torch.from_numpy(ct_ga))
    _assert_grads(g, _flat(jg))


def test_torch_scann_apply_grads_match_jax_kernel():
    """torch.autograd through scann_apply (its backward is the backward
    kernel's wrapper) gives the JAX kernel's gradients of the same loss."""
    jcfg, tcfg, jparams, tparams, inputs, tinputs = _setup(4, g_update=True)
    rng = np.random.default_rng(5)
    ct_pred = rng.normal(size=(3, 1)).astype(np.float32)
    ct_ga = rng.normal(size=(3, 12, 1)).astype(np.float32)
    jg = _flat(jax_fused_grad(jparams, inputs, jcfg, ct_pred, ct_ga, interpret=True,
                              batch_tile=1))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    pred, ga = kbwd.scann_apply(leaves, tinputs, tcfg)
    loss = (pred * torch.from_numpy(ct_pred)).sum() + (ga * torch.from_numpy(ct_ga)).sum()
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    _assert_grads(got, jg)


def test_torch_dropout_masks_injected_into_the_eager_model():
    """At dropout 0.1 under use_drop the plain versions run the eager model
    with the Philox masks injected: the same numbers as handing those masks
    to ``scann_forward`` directly, different from dropout 0, and the same
    masks in the forward wrapper and in ``scann_apply``."""
    _, tcfg, _, tparams, _, x = _setup(6, g_update=True, use_drop=True)
    masks = make_dropout_masks(42, 0, 3, 12, 6, 32, 4, 2, 0.1, 0.05)
    with torch.no_grad():
        want, want_ga = scann_forward(tparams, x, tcfg, False, masks)
        got, got_ga = kfwd.fused_scann_forward(tparams, x, tcfg, False, 0.1, 42)
        det, _ = kfwd.fused_scann_forward(tparams, x, tcfg)
        applied, _ = kbwd.scann_apply(tparams, x, tcfg, False, 0.1, 42)
    assert torch.equal(got, want) and torch.equal(got_ga, want_ga) and torch.equal(applied, want)
    assert not torch.allclose(got, det)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    pred, _ = scann_forward(leaves, x, tcfg, False, masks)
    want_g = dict(zip(leaves, torch.autograd.grad(pred.sum(), list(leaves.values()))))
    g = kbwd.fused_scann_grad(tparams, x, tcfg, torch.ones(3, 1), torch.zeros(3, 12, 1), 0.1, 42)
    for k in want_g:
        torch.testing.assert_close(g[k], want_g[k], rtol=0, atol=0)


def test_torch_dropout_gradient_matches_finite_difference():
    """With a fixed dropout seed the training loss is a deterministic
    function of the params; its gradient matches central finite differences
    along a normalised random direction (as tests/test_kernels.py:520-566)."""
    _, tcfg, _, tparams, _, x = _setup(7, B=2, M=8, N=4, g_update=True, use_drop=True)
    y = torch.tensor([0.3, -0.7])

    def loss(p):
        pred, ga = kfwd.fused_scann_forward(p, x, tcfg, False, 0.1, 42)
        return torch.sqrt(torch.mean((pred[:, 0] - y) ** 2)) + 0.05 * torch.sum(ga ** 2)

    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    pred, ga = kbwd.scann_apply(leaves, x, tcfg, False, 0.1, 42)
    total = torch.sqrt(torch.mean((pred[:, 0] - y) ** 2)) + 0.05 * torch.sum(ga ** 2)
    g = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
    rng = np.random.default_rng(8)
    dirs = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
            for k, v in tparams.items()}
    norm = float(torch.sqrt(sum((d * d).sum() for d in dirs.values())))
    eps = 1e-2
    with torch.no_grad():
        plus = loss({k: v + eps * dirs[k] / norm for k, v in tparams.items()})
        minus = loss({k: v - eps * dirs[k] / norm for k, v in tparams.items()})
    fd = float(plus - minus) / (2 * eps)
    analytic = float(sum((g[k] * dirs[k]).sum() for k in g)) / norm
    assert fd == pytest.approx(analytic, rel=2e-2, abs=1e-4)


def test_torch_backward_gate_and_layout():
    cfm = ModelConfig()
    kbwd.check_supported(cfm, 32, 16)
    kbwd.check_supported(cfm, 32, 24)
    # chunk buffers padded to strides of 2D + 4 and D + 4 floats, two rows of bias sums
    assert kbwd.shared_memory_plan(cfm, 32, 16) == (2, 222336)
    assert kbwd.shared_memory_plan(cfm, 32, 24)[0] == 1
    assert kbwd.refusal(cfm, 32, 16) is None and kbwd.refusal(cfm, 32, 32) is None
    with pytest.raises(NotImplementedError, match="loop kernel"):
        kbwd.check_supported(cfm, 96, 16)
    with pytest.raises(NotImplementedError, match="shared-memory plan"):
        kbwd.check_supported(cfm, 40, 16)
    with pytest.raises(NotImplementedError, match="sizes"):
        kbwd.check_supported(cfm, 32, 40)
    # packed slots: the per-segment vectors join the plan; at the QM9
    # capacity of 32 the plan takes up to 15 segments a slot
    assert kbwd.shared_memory_plan(cfm, 32, 16, 8) == (2, 222336)
    assert kbwd.max_segments(cfm, 32, 16) == 15
    assert kbwd.refusal(cfm, 32, 16, 15) is None
    with pytest.raises(NotImplementedError, match="S=16: the backward's shared-memory plan"):
        kbwd.check_supported(cfm, 32, 16, 16)
    with pytest.raises(NotImplementedError, match="pack_max_segments"):
        kbwd.check_supported(cfm, 16, 16, kfwd.MAX_SEGMENTS + 1)
    # the flat gradient round-trips into params-keyed views
    params = {k: torch.randn(v) for k, v in param_shapes(cfm).items()}
    packed = kfwd.pack_params(params, cfm)
    offsets, P = kbwd.grad_layout(packed)
    assert P % 4 == 0 and all(o % 4 == 0 for o in offsets if o >= 0)
    flat = torch.cat([torch.cat([packed[n].reshape(-1), torch.zeros(-packed[n].numel() % 4)])
                      for n, o in zip(kbwd.GRAD_NAMES, offsets) if o >= 0])
    views = kbwd.grads_from_flat(flat, packed, cfm)
    assert set(views) == set(params)
    assert all(torch.equal(views[k], params[k]) for k in params)


def test_torch_backward_flops_qm9():
    """The function needs ~1.5e11 FLOP per QM9 training batch (B=128, M=32,
    N=16), just under 3x the forward (data inputs need no gradient): the
    count the kernel's bound is computed from. The schedule's recompute is
    counted apart, at just under one forward (the context is stashed)."""
    cfm = ModelConfig()
    fwd = kfwd.forward_flops(cfm, 128, 32, 16)
    f = kbwd.backward_flops(cfm, 128, 32, 16)
    assert 1.45e11 < f < 1.55e11
    assert 2.9 < f / fwd < 3.0
    assert 0.95 < kbwd.recompute_flops(cfm, 128, 32, 16) / fwd < 1.0
    assert kbwd.backward_flops(cfm, 64, 32, 16) * 2 == f


@pytest.mark.parametrize("M,N", [(32, 16), (96, 32)])
def test_torch_fp32_flops_are_the_energies_context_and_head(M, N):
    """The part of the FLOP count that runs on the CUDA cores (the rest are
    split-TF32 products): each layer's energies and context (2 x 2 M N D),
    the readout's elementwise terms and the one-row head; the backward's is
    three times the forward's, and both are a few percent of the whole."""
    cfm = ModelConfig()
    L, D, G, O = cfm.n_attention, cfm.local_dim, cfm.global_dim, cfm.dense_out
    fwd = kfwd.forward_fp32_flops(cfm, 2, M, N)
    assert fwd == 2 * (L * 4 * M * N * D + 6 * M * G + 2 * G * O + 2 * O)
    assert kbwd.backward_fp32_flops(cfm, 2, M, N) == 3 * fwd
    assert 0 < fwd / kfwd.forward_flops(cfm, 2, M, N) < 0.02


def test_torch_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """Editing a header that a kernel includes changes that kernel's
    library path, so a stale build is never loaded."""
    for f in ("scann_backward.cu", "scann_mma.cuh", "scann_grad_common.cuh", "scann_common.cuh",
              "philox.cuh"):
        (tmp_path / f).write_text(open(f"{_build.SRC_DIR}/{f}").read())
    monkeypatch.setattr(_build, "SRC_DIR", str(tmp_path))
    names = [p.rsplit("/", 1)[1] for p in _build.source_files("scann_backward")]
    assert names == ["scann_backward.cu", "philox.cuh", "scann_mma.cuh", "scann_grad_common.cuh",
                     "scann_common.cuh"]
    before = _build.library_path("scann_backward")
    (tmp_path / "philox.cuh").write_text((tmp_path / "philox.cuh").read_text() + "\n// edit\n")
    after = _build.library_path("scann_backward")
    assert after != before
    (tmp_path / "scann_mma.cuh").write_text((tmp_path / "scann_mma.cuh").read_text() + "\n// edit\n")
    assert _build.library_path("scann_backward") not in (before, after)


def test_torch_backward_plan_matches_cuda_source():
    """``shared_memory_plan`` mirrors ``make_plan`` of ``csrc/scann_backward.cu``:
    the padded strides of the chunk buffers are read from the source, and the
    QM9 plan is rebuilt term by term."""
    with open(_build.source_files("scann_backward")[0]) as f:
        src = f.read()
    plan = src[src.index("inline Plan make_plan"):src.index("__global__")]
    assert "p.lda = 2 * a.D + 4;" in plan and "p.ldu = a.D + 4;" in plan
    assert "p.total = p.offAcc + 2 * p.wd;" in plan
    cfm = ModelConfig()
    D, H, M, wd = cfm.local_dim, cfm.num_head, 32, 128
    MW = M * wd
    chunk = 32 * (2 * D + 4) + 3 * 32 * (D + 4) + 3 * 32 * H
    assert kbwd.chunk_floats(32, D, H) == chunk
    work = max(chunk, 5 * MW + 4 * wd + 4 * M + 3 * cfm.dense_out + 4, 6 * MW + M,
               2 * M * 48 + MW)
    assert kbwd.shared_memory_plan(cfm, M, 16)[1] == 4 * (7 * MW + work + 8 * 2 * wd + 2 * wd)


@pytest.mark.parametrize("rows,K,nc", [(32, 256, 128), (32, 128, 128), (24, 20, 128), (8, 58, 60)])
def test_torch_tf32x3_matmul_keeps_f32_accuracy(rows, K, nc):
    """Why the tolerances of the backward kernels stay where they were: the
    split product the kernels run on the tensor cores (operands rounded to
    TF32's 10 mantissa bits, three passes, small terms first) is within 2e-6
    x max |exact| of a float64 product, as an FP32 FMA loop is, where a single
    TF32 pass is more than 100 times further off."""
    g = torch.Generator().manual_seed(rows + K)
    a, b = torch.randn(rows, K, generator=g), torch.randn(K, nc, generator=g)
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    three = float((kbwd.reference_tf32x3_matmul(a, b).double() - exact).abs().max()) / scale
    one = float((kbwd.reference_tf32x3_matmul(a, b, passes=1).double() - exact).abs().max()) / scale
    fp32 = float(((a @ b).double() - exact).abs().max()) / scale
    assert three <= 2e-6
    assert one > 100 * three
    assert three <= 4 * fp32 + 1e-7


def test_torch_round_tf32():
    """``round_tf32`` keeps 10 mantissa bits, to nearest, ties away from zero."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23, -1.0 - 2.0 ** -11,
                      3.14159265, 0.0])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0, -1.0 - 2.0 ** -10, 3.140625, 0.0])
    assert torch.equal(kbwd.round_tf32(x), want)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = kbwd.round_tf32(y)
    assert float(((y - hi).abs() / y.abs()).max()) <= 2.0 ** -11
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros(1000, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kbwd.mma_selftest(torch.zeros(4, 8), torch.zeros(8, 4), torch.zeros(4, 4))


def test_torch_build_reads_ptxas_resource_report(monkeypatch):
    """``kernel_resources`` reads registers and spills of each kernel from
    what ``ptxas -v`` printed during the build (the build asks for it)."""
    assert _build.NVCC_FLAGS[-2:] == ["-Xptxas", "-v"]
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN5scann17scann_reduce_rowsEPKfixPf' for 'sm_90a'
ptxas info    : Function properties for _ZN5scann17scann_reduce_rowsEPKfixPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 18 registers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN1a21scann_backward_kernelE' for 'sm_90a'
ptxas info    : Function properties for _ZN1a21scann_backward_kernelE
    40 bytes stack frame, 32 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 40 bytes cumulative stack size
"""
    monkeypatch.setitem(_build.build_logs, "scann_backward", log)
    assert _build.kernel_resources("scann_backward") == [
        ("_ZN5scann17scann_reduce_rowsEPKfixPf", 18, 0, 0),
        ("_ZN1a21scann_backward_kernelE", 255, 32, 36)]
    assert _build.kernel_resources("not_built_here") == []
