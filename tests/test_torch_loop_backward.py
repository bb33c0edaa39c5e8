"""The PyTorch port's crystal loop backward on the CPU (its plain version)
against the JAX package's loop backward kernel, run in interpret mode, in
float32: the same flax parameters (moved with ``params_from_jax``) and the
same seeded inputs (``conftest.make_synthetic_batch``). Gradients are held
per tensor at atol 2e-5 x max |reference|, pred at rtol 1e-5 / atol 1e-6.
Also: ``loop_scann_apply`` under ``torch.autograd``, dropout (masks shared by
forward and backward, gradient against finite differences), the backward's
gate and which of the three training routes ``Trainer.train_route`` picks."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import jit_init_vars, make_synthetic_batch
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.kernels.scann_loop import loop_scann_grad as jax_loop_grad
from scann_tpu.kernels.scann_loop import loop_scann_train_grads as jax_loop_train_grads
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu_torch.compat import params_from_jax
from scann_tpu_torch.config import ModelConfig, ScannConfig
from scann_tpu_torch.kernels import _build
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.models import init_params, scann_forward
from scann_tpu_torch.ops.dropout import make_dropout_masks
from scann_tpu_torch.train import loop as train_loop

torch.set_num_threads(1)

GRAD_TOL = 2e-5
SMALL = dict(n_atoms=12, embedding_dim=16, n_attention=2, local_dim=32,
             num_head=4, global_dim=32, dense_out=16)
B, M, N = 3, 16, 8


def _setup(seed, mrelu=False, **kw):
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


CASES = {  # the two crystal recipes' kinds, small: MP2018 is SCANN+, ptgp SCANN with rings
    "scann+ ga_norm": dict(g_update=True, use_ga_norm=True),
    "scann ring": dict(g_update=False, use_ga_norm=True, use_ring=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_torch_loop_grad_matches_jax_kernel(case):
    """Cotangent mode, with a GA cotangent; ``loop_scann_apply`` under
    ``torch.autograd`` gives the same gradients of the same loss."""
    jcfg, tcfg, jparams, tparams, inputs, tinputs = _setup(1, **CASES[case])
    rng = np.random.default_rng(3)
    ct_pred = rng.normal(size=(B, 1)).astype(np.float32)
    ct_ga = rng.normal(size=(B, M, 1)).astype(np.float32)
    want = _flat(jax_loop_grad(jparams, inputs, jcfg, ct_pred, ct_ga, interpret=True))
    got = kloop.loop_scann_grad(tparams, tinputs, tcfg, torch.from_numpy(ct_pred),
                                torch.from_numpy(ct_ga))
    _assert_grads(got, want)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    pred, ga = kloop.loop_scann_apply(leaves, tinputs, tcfg)
    loss = (pred * torch.from_numpy(ct_pred)).sum() + (ga * torch.from_numpy(ct_ga)).sum()
    applied = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    for k in got:
        torch.testing.assert_close(applied[k], got[k], rtol=0, atol=0)


@pytest.mark.parametrize("case,mrelu", [("scann+ ga_norm", False), ("scann ring", True)])
def test_torch_loop_train_grads_match_jax_kernel(case, mrelu):
    """One-shot mode at dropout 0: pred and the raw gradients of
    0.5 * sum((pred - t)^2); mrelu is straight-through."""
    jcfg, tcfg, jparams, tparams, inputs, tinputs = _setup(2, mrelu=mrelu, **CASES[case])
    y = np.linspace(-1, 1, B, dtype=np.float32)
    jpred, jraw = jax_loop_train_grads(jparams, inputs, y, jcfg, mrelu_head=mrelu,
                                       interpret=True)
    pred, raw = kloop.loop_scann_train_grads(tparams, tinputs, torch.from_numpy(y), tcfg, mrelu)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5, atol=1e-6)
    _assert_grads(raw, _flat(jraw))


def test_torch_loop_dropout_masks_shared_by_forward_and_backward():
    """At dropout 0.1 under use_drop the plain versions run the eager model
    with the Philox masks injected: the loop forward, ``loop_scann_apply`` and
    the backward all see the masks of ``make_dropout_masks``."""
    tcfg = ModelConfig(**SMALL, g_update=True, use_drop=True)
    tparams = init_params(tcfg, torch.Generator().manual_seed(0))
    x = {k: torch.from_numpy(v) for k, v in
         make_synthetic_batch(np.random.default_rng(6), B=B, M=M, N=N).items()}
    masks = make_dropout_masks(42, 0, B, M, N, 32, 4, 2, 0.1, 0.05)
    with torch.no_grad():
        want, want_ga = scann_forward(tparams, x, tcfg, False, masks)
        got, got_ga = kloop.loop_scann_forward(tparams, x, tcfg, False, 0.1, 42)
        det, _ = kloop.loop_scann_forward(tparams, x, tcfg)
        applied, _ = kloop.loop_scann_apply(tparams, x, tcfg, False, 0.1, 42)
    assert torch.equal(got, want) and torch.equal(got_ga, want_ga) and torch.equal(applied, want)
    assert not torch.allclose(got, det)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    pred, _ = scann_forward(leaves, x, tcfg, False, masks)
    want_g = dict(zip(leaves, torch.autograd.grad(pred.sum(), list(leaves.values()))))
    g = kloop.loop_scann_grad(tparams, x, tcfg, torch.ones(B, 1), torch.zeros(B, M, 1), 0.1, 42)
    for k in want_g:
        torch.testing.assert_close(g[k], want_g[k], rtol=0, atol=0)
    y = torch.linspace(-1, 1, B)
    pred1, raw = kloop.loop_scann_train_grads(tparams, x, y, tcfg, False, 0.1, 42)
    assert torch.equal(pred1, want)
    g1 = kloop.loop_scann_grad(tparams, x, tcfg, want[:, 0] - y, torch.zeros(B, M, 1), 0.1, 42)
    for k in raw:
        torch.testing.assert_close(raw[k], g1[k], rtol=1e-6, atol=1e-7)


def test_torch_loop_dropout_gradient_matches_finite_difference():
    """With a fixed dropout seed the training loss is a deterministic
    function of the params; the gradient through ``loop_scann_apply`` matches
    central finite differences along a normalised random direction."""
    tcfg = ModelConfig(**SMALL, g_update=True, use_drop=True)
    tparams = init_params(tcfg, torch.Generator().manual_seed(1))
    x = {k: torch.from_numpy(v) for k, v in
         make_synthetic_batch(np.random.default_rng(7), B=2, M=M, N=4).items()}
    y = torch.tensor([0.3, -0.7])

    def loss(p):
        pred, ga = kloop.loop_scann_forward(p, x, tcfg, False, 0.1, 42)
        return torch.sqrt(torch.mean((pred[:, 0] - y) ** 2)) + 0.05 * torch.sum(ga ** 2)

    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    pred, ga = kloop.loop_scann_apply(leaves, x, tcfg, False, 0.1, 42)
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


MP2018 = ModelConfig(n_atoms=95, embedding_dim=128, n_attention=9, gaussian_d=6.0)
PTGP = ModelConfig(n_atoms=80, n_attention=11, use_ring=True, g_update=False)


def test_torch_loop_backward_gate_and_layout():
    """The gate is the kernel's own shared-memory plan: atom blocks of 32
    up to M = 106, of 16 up to 186, of 8 up to 226 at N = 32 and D = G = 128
    (the chunk buffers carry 4 floats of padding per row for the tensor-core
    fragment reads; the readout's vectors live in the work region, which
    lifted the gate from 96 / 168 / 208); chunks of at most 32 rows, so
    N <= 32."""
    assert kloop.loop_backward_memory_plan(MP2018, 96, 32) == (1, 32, 227328)
    assert kloop.loop_backward_memory_plan(MP2018, 104, 32)[1] == 32
    assert kloop.loop_backward_memory_plan(MP2018, 106, 32)[1:] == (32, kfwd.MAX_SHARED_BYTES)
    assert kloop.loop_backward_memory_plan(MP2018, 112, 32)[1] == 16
    assert kloop.loop_backward_memory_plan(MP2018, 168, 32)[1:] == (16, 223232)
    assert kloop.loop_backward_memory_plan(MP2018, 186, 32)[1] == 16
    assert kloop.loop_backward_memory_plan(MP2018, 192, 32)[1] == 8
    assert kloop.loop_backward_memory_plan(PTGP, 128, 32)[:2] == (1, 16)
    assert kloop.loop_backward_memory_plan(MP2018, 96, 16)[0] == 2
    assert kloop.loop_backward_memory_plan(MP2018, 16, 8)[:2] == (4, 16)
    for M_ok in (8, 96, 128, 208, 216, 226):
        assert kloop.backward_refusal(MP2018, M_ok, 32) is None
        kloop.check_backward_supported(MP2018, M_ok, 32)
    assert kloop.loop_backward_memory_plan(MP2018, 226, 32)[2] <= kfwd.MAX_SHARED_BYTES
    assert kloop.loop_backward_memory_plan(MP2018, 227, 32)[2] > kfwd.MAX_SHARED_BYTES
    with pytest.raises(NotImplementedError, match="per-layer model"):
        kloop.check_backward_supported(MP2018, 232, 32)
    # the forward still takes what the backward leaves to the per-layer model
    assert kloop.refusal(MP2018, 232, 32) is None
    assert "chunks of at most 32" in kloop.backward_refusal(MP2018, 96, 40)
    assert kloop.refusal(MP2018, 96, 40) is None
    assert "use_attn_norm" in kloop.backward_refusal(
        dataclasses.replace(MP2018, use_attn_norm=False), 96, 32)
    assert "float32" in kloop.backward_refusal(dataclasses.replace(MP2018, dtype="bfloat16"),
                                               96, 32)
    with pytest.raises(NotImplementedError, match="packing"):
        kloop.loop_scann_train_grads({}, {"atomic": torch.zeros(1, 8),
                                          "neighbors": torch.zeros(1, 8, 4),
                                          "segment_onehot": None}, None, MP2018)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kloop.launch_loop_backward({"wde": torch.zeros(1)}, {}, MP2018, None, None, True)
    assert "scann_loop_backward" in _build.SOURCES
    assert [f.rsplit("/", 1)[-1] for f in _build.source_files("scann_loop_backward")] == [
        "scann_loop_backward.cu", "philox.cuh", "scann_mma.cuh", "scann_grad_common.cuh",
        "scann_common.cuh"]
    assert "scann_mma.cuh" in [f.rsplit("/", 1)[-1]
                               for f in _build.source_files("scann_backward")]
    # the forward kernels do not include the backwards' headers
    for name in ("scann_forward", "scann_loop", "local_attention"):
        assert not {"scann_mma.cuh", "scann_grad_common.cuh"} & {
            f.rsplit("/", 1)[-1] for f in _build.source_files(name)}
    assert "scann_grad_common.cuh" in [f.rsplit("/", 1)[-1]
                                       for f in _build.source_files("scann_backward")]


def test_torch_loop_backward_flops():
    """What the function needs at the MP2018 batch is three forwards less the
    input gradients of data; the schedule's recompute is about one forward."""
    fwd = kloop.loop_forward_flops(MP2018, 64, 96, 32)
    need = kloop.loop_backward_flops(MP2018, 64, 96, 32)
    assert need == kbwd.backward_flops(MP2018, 64, 96, 32)
    assert need == pytest.approx(5.53e11, rel=1e-2) and 2.9 * fwd < need < 3 * fwd
    again = kloop.loop_recompute_flops(MP2018, 64, 96, 32)
    assert 0.95 * fwd < again < fwd
    assert kloop.loop_recompute_flops(PTGP, 64, 128, 32) < kloop.loop_forward_flops(
        PTGP, 64, 128, 32)


TRAIN_ROUTES = [
    (ModelConfig(), 32, 16, "fused"),
    (MP2018, 24, 16, "fused"),
    (MP2018, 96, 32, "loop"),
    (MP2018, 48, 24, "loop"),
    (PTGP, 128, 32, "loop"),
    (MP2018, 208, 32, "loop"),
    (MP2018, 216, 32, "loop"),
    (MP2018, 232, 32, "per_layer"),
    (MP2018, 96, 40, "per_layer"),
    (dataclasses.replace(MP2018, use_attn_norm=False), 24, 16, "per_layer"),
    (dataclasses.replace(MP2018, use_attn_norm=False), 96, 32, "per_layer"),
]


@pytest.mark.parametrize("cfm,M,N,route", TRAIN_ROUTES)
def test_torch_train_route_dispatch(cfm, M, N, route, monkeypatch):
    """``raw_grads`` on a CUDA trainer picks its route from the gates alone:
    the launchers are patched to counters, nothing is launched, and the loop
    backward's scratch is allocated once per batch shape."""
    cfm = dataclasses.replace(cfm, n_attention=1, embedding_dim=8)
    trainer = train_loop.Trainer(ScannConfig(model=cfm), "cpu", "unused")
    trainer.load_params(init_params(cfm, torch.Generator().manual_seed(0)))
    trainer.device = torch.device("cuda")       # only the dispatch reads it here
    calls, scratches = [], []
    # use_attn_norm=False has no ResidualNorm weights to pack: it never reaches a kernel
    P = 0 if route == "per_layer" else kbwd.grad_layout(trainer.kernel_params())[1]

    def fake(name):
        def run(*args, **kw):
            calls.append((name, kw.get("scratch")))
            return torch.zeros(P), torch.zeros(1)
        return run

    def fake_per_layer(batch, y, seed):
        calls.append(("per_layer", None))
        return torch.zeros(1), {}

    def fake_scratch(packed, cfm_, B_, M_, N_):
        scratches.append((B_, M_, N_))
        return {"id": len(scratches)}

    monkeypatch.setattr(train_loop, "launch_scann_backward", fake("fused"))
    monkeypatch.setattr(train_loop, "launch_loop_backward", fake("loop"))
    monkeypatch.setattr(trainer, "_per_layer_grads", fake_per_layer)
    monkeypatch.setattr(train_loop.kloop, "loop_backward_scratch", fake_scratch)
    batch = {"atomic": torch.zeros(1, M, dtype=torch.int32),
             "neighbors": torch.zeros(1, M, N, dtype=torch.int32)}
    assert trainer.train_route(M, N) == route
    trainer.raw_grads(batch, torch.zeros(1), 0)
    trainer.raw_grads(batch, torch.zeros(1), 1)
    assert [c[0] for c in calls] == [route, route]
    if route == "loop":
        assert scratches == [(1, M, N)] and calls[0][1] == calls[1][1] == {"id": 1}
    else:
        assert scratches == []


def test_torch_per_layer_route_matches_loop_route():
    """On the CPU the third route (the per-layer model under autograd) gives
    the gradients of the loop route's plain version, on the same masks."""
    cfm = ModelConfig(**SMALL, g_update=True)
    trainer = train_loop.Trainer(ScannConfig(model=cfm), "cpu", "unused")
    trainer.init_state(3)
    x = {k: torch.from_numpy(v) for k, v in
         make_synthetic_batch(np.random.default_rng(9), B=B, M=40, N=N).items()}
    y = torch.linspace(-1, 1, B)
    pred, raw = kloop.loop_scann_train_grads(trainer.params, x, y, cfm, False,
                                             trainer.dropout_rate, 5)
    pred2, raw2 = trainer._per_layer_grads(x, y, 5)
    torch.testing.assert_close(pred2, pred[:, 0], rtol=1e-6, atol=1e-7)
    assert set(raw2) == set(raw)
    for k in raw:
        torch.testing.assert_close(raw2[k], raw[k], rtol=1e-5,
                                   atol=1e-6 * float(raw[k].abs().max()) + 1e-9)


@pytest.mark.parametrize("B_,C", [(1, 4), (8, 4), (28, 4), (29, 2), (32, 2), (64, 2), (66, 2),
                                  (67, 1), (128, 1), (1024, 1)])
def test_torch_loop_backward_cluster_size(B_, C):
    """Blocks per structure are a function of the batch size alone: the
    largest of 4, 2, 1 whose clusters all run at once on the card (2 at the
    MP2018 batch of 64: 128 blocks on 132 SMs)."""
    assert kloop.cluster_size(B_) == C
    assert kloop.CLUSTER_SIZES == (4, 2, 1) and C in kloop.CLUSTER_SIZES
    assert B_ <= kloop.CLUSTERS_AT_ONCE[C] or C == 1
    if C < 4:
        assert B_ > kloop.CLUSTERS_AT_ONCE[2 * C]
    assert all(c * n <= 132 for c, n in kloop.CLUSTERS_AT_ONCE.items())


@pytest.mark.parametrize("C", [None, 1, 2, 4])
def test_torch_loop_backward_scratch_shapes(C):
    """One gradient row per block: [B * C, P]; the stashes do not depend on C.
    A scratch of another cluster size is refused before any launch."""
    cfm = ModelConfig(**SMALL, g_update=True)
    packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0)), cfm)
    B_, M_, N_ = 5, 40, 8
    scratch = kloop.loop_backward_scratch(packed, cfm, B_, M_, N_, C)
    L, D = cfm.n_attention, cfm.local_dim
    P = kbwd.grad_layout(packed)[1]
    blocks = B_ * (C or kloop.cluster_size(B_))
    assert scratch["rows"].shape == (blocks, P)
    assert scratch["c_stash"].shape == (B_, L + 1, M_, D)
    assert scratch["o_stash"].shape == (B_, L, M_, D)
    assert scratch["g_stash"].shape == (B_, L, M_ * N_, D)
    assert scratch["dgeo"].shape == (B_, M_ * N_, D)
    assert scratch["dcenters"].shape == (B_, M_, D)
    x = {k: torch.from_numpy(v) for k, v in
         make_synthetic_batch(np.random.default_rng(1), B=B_, M=M_, N=N_).items()}
    other = 2 if (C or 4) != 2 else 1
    with pytest.raises(ValueError, match="blocks per structure"):
        kloop._launch_backward(packed, x, cfm, torch.zeros(B_), None, True, scratch=scratch,
                               cluster=other)
    with pytest.raises(ValueError, match="launches with"):
        kloop._launch_backward(packed, x, cfm, torch.zeros(B_), None, True, cluster=3)


def test_torch_loop_backward_plan_matches_cuda_source():
    """``loop_backward_memory_plan`` mirrors ``make_plan`` of
    ``csrc/scann_loop_backward.cu``: the padded strides of the chunk buffers
    and the terms of the plan are read from the source."""
    import re
    with open(_build.source_files("scann_loop_backward")[0]) as f:
        src = f.read()
    plan = src[src.index("inline Plan make_plan"):src.index("__global__")]
    assert "p.lda = 2 * a.D + 4;" in plan and "p.ldu = a.D + 4;" in plan
    assert re.search(r"chunk = p\.rows \* p\.lda \+ 3 \* p\.rows \* p\.ldu \+ 3 \* "
                     r"round4\(p\.rows \* a\.H\)", plan)
    assert "p.total = p.offAcc + 2 * p.wd;" in plan
    D, H = MP2018.local_dim, MP2018.num_head
    assert kbwd.chunk_floats(32, D, H) == 32 * (2 * D + 4) + 3 * 32 * (D + 4) + 3 * 32 * H
    # the whole plan at the MP2018 bucket, term by term as make_plan adds them
    wd, AB, M_, O = 128, 32, 96, MP2018.dense_out
    work = max(kbwd.chunk_floats(32, D, H), 5 * AB * wd + AB,
               AB * 2 * 128 + AB * wd, AB * wd + 4 * wd + 5 * M_ + 3 * O + 4)
    total = M_ * wd + 5 * AB * wd + work + 8 * 2 * wd + 2 * wd
    assert kloop.loop_backward_memory_plan(MP2018, M_, 32)[2] == 4 * total
    assert (D + 4) % 32 == 4 and (2 * D + 4) % 32 == 4      # conflict-free fragment reads
