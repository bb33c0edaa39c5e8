"""The PyTorch port's per-layer LocalAttention against the JAX package on the
CPU, in float32: the plain layer against the JAX Pallas kernel in interpret
mode and its reference; the ``autograd.Function``'s gradients against
``jax.grad``; the per-layer model against the eager one; and which of the
three forward routes ``Trainer.forward_eval`` picks for a CUDA batch."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scann_tpu.kernels.local_attention as jla
from conftest import jit_apply, jit_init_vars, make_synthetic_batch
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu_torch.compat import params_from_jax
from scann_tpu_torch.config import ModelConfig, ScannConfig
from scann_tpu_torch.kernels import local_attention as kla
from scann_tpu_torch.models import ScannModel, init_params, scann_forward
from scann_tpu_torch.train import loop as train_loop
from test_kernels import make_layer_inputs

torch.set_num_threads(1)

SMALL = dict(n_atoms=10, embedding_dim=8, n_attention=2, local_dim=32, num_head=4,
             global_dim=32, dense_out=16)


def _flat(params):
    """The JAX layer's nested params as the port's flat dict of tensors."""
    return {f"{mod}/{name}": torch.from_numpy(np.asarray(v))
            for mod, leaves in params.items() for name, v in leaves.items()}


def _tensors(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("g_update", [True, False])
def test_torch_plain_layer_matches_jax_kernel_and_reference(rng, g_update):
    centers, idx, geometry, mask, weight, params = make_layer_inputs(rng, g_update=g_update)
    H, scale = 4, 0.5
    jargs = [jnp.asarray(a) for a in (centers, idx, geometry, mask, weight)]
    kernel = jla._pallas_forward(*jargs, params, H, scale, g_update, interpret=True)
    reference = jla.reference_local_attention(*jargs, params, H, scale, g_update)
    with torch.no_grad():
        out, geo, attn = kla.reference_local_attention(
            *_tensors(centers, idx, geometry, mask, weight), _flat(params), H, scale, g_update)
        f_out, f_geo, f_attn = kla.fused_local_attention(
            *_tensors(centers, idx, geometry, mask, weight), _flat(params), H, scale, g_update)
    assert (geo is None) == (not g_update)
    for want_out, want_geo, want_attn in (kernel, reference):
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), rtol=1e-4, atol=1e-6)
        if g_update:
            np.testing.assert_allclose(geo.numpy(), np.asarray(want_geo),
                                       rtol=1e-4, atol=1e-5)
    # the differentiable wrapper on CPU tensors is the plain layer; for SCANN
    # its geometry output is the unchanged input
    assert torch.equal(f_out, out) and torch.equal(f_attn, attn)
    assert torch.equal(f_geo, geo if g_update else torch.from_numpy(geometry))
    assert kla.fused_local_attention.launches == 0


@pytest.mark.parametrize("g_update", [True, False])
def test_torch_fused_layer_gradients_match_jax_grad(rng, g_update):
    centers, idx, geometry, mask, weight, params = make_layer_inputs(
        rng, B=2, M=8, N=4, D=16, g_update=g_update)
    H, scale = 2, 0.5
    probe = rng.normal(size=(2, 8, 4, H)).astype(np.float32)   # a cotangent for attn

    def jax_loss(c, g, w, p):
        out, geo, attn = jla.reference_local_attention(
            c, jnp.asarray(idx), g, jnp.asarray(mask), w, p, H, scale, g_update)
        if geo is None:
            geo = g
        return jnp.sum(out ** 2) + jnp.sum(geo ** 2) + jnp.sum(attn * probe)

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2, 3)))(
        jnp.asarray(centers), jnp.asarray(geometry), jnp.asarray(weight),
        jax.tree.map(jnp.asarray, params))

    c, _, g, m, w = _tensors(centers, idx, geometry, mask, weight)
    flat = _flat(params)
    leaves = [t.requires_grad_(True) for t in (c, g, w, *flat.values())]
    out, geo, attn = kla.fused_local_attention(c, torch.from_numpy(idx), g, m, w, flat, H,
                                               scale, g_update)
    loss = (out ** 2).sum() + (geo ** 2).sum() + (attn * torch.from_numpy(probe)).sum()
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    got_c, got_g, got_w, *got_p = got
    pairs = [(got_c, want[0]), (got_g, want[1])]
    if g_update:
        assert got_w is None          # the solid-angle weight is a SCANN input only
    else:
        pairs.append((got_w, want[2]))
    want_p = {f"{mod}/{name}": v for mod, d in want[3].items() for name, v in d.items()}
    pairs += [(gp, want_p[k]) for k, gp in zip(flat, got_p)]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("g_update,attn_norm", [(True, True), (False, True), (True, False)])
def test_torch_per_layer_model_matches_eager_and_jax_pallas_model(rng, g_update, attn_norm,
                                                                   monkeypatch):
    kw = dict(SMALL, g_update=g_update, use_attn_norm=attn_norm)
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    inputs = make_synthetic_batch(rng, B=3, M=8, N=4)
    jparams = jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(0), inputs)
    monkeypatch.setattr(jla, "_pallas_forward",
                        functools.partial(jla._pallas_forward, interpret=True))
    want = JaxScannModel(config=jcfg, use_pallas=True).apply(jparams, inputs,
                                                            deterministic=True)
    eager_jax = jit_apply(JaxScannModel(config=jcfg))(jparams, inputs)
    tparams = params_from_jax(jax.device_get(jparams), tcfg)
    tin = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    with torch.no_grad():
        pred, ga = scann_forward(tparams, tin, tcfg, use_pallas=True)
        eager_p, eager_g = scann_forward(tparams, tin, tcfg)
        module = ScannModel(tcfg, params=tparams, use_pallas=True)(tin)
    assert torch.equal(pred, eager_p) and torch.equal(ga, eager_g)   # CPU: the plain layer
    assert torch.equal(module["property"], pred)
    for ref in (want, eager_jax):
        np.testing.assert_allclose(pred.numpy(), np.asarray(ref["property"]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ga.numpy(), np.asarray(ref["ga_score"]),
                                   rtol=1e-4, atol=1e-5)


MP2018 = ModelConfig(n_atoms=95, embedding_dim=128, n_attention=9, gaussian_d=6.0)
PTGP = ModelConfig(n_atoms=80, n_attention=11, use_ring=True, g_update=False)
ROUTES = [
    (ModelConfig(), 32, 16, "fused"),
    (ModelConfig(), 64, 16, "fused"),
    (MP2018, 48, 24, "fused"),
    (MP2018, 96, 32, "loop"),
    (PTGP, 128, 32, "loop"),
    (MP2018, 192, 32, "loop"),
    (MP2018, 256, 32, "per_layer"),
    (MP2018, 1024, 48, "per_layer"),
    (dataclasses.replace(MP2018, use_attn_norm=False), 32, 16, "per_layer"),
    (dataclasses.replace(MP2018, use_attn_norm=False), 96, 32, "per_layer"),
]


@pytest.mark.parametrize("cfm,M,N,route", ROUTES)
def test_torch_forward_eval_dispatch(cfm, M, N, route, monkeypatch):
    """``forward_eval`` on a CUDA trainer picks its route from the gates
    alone: the launchers are patched to counters, nothing is launched."""
    cfm = dataclasses.replace(cfm, n_attention=1, embedding_dim=8)
    trainer = train_loop.Trainer(ScannConfig(model=cfm), "cpu", "unused")
    trainer.load_params(init_params(cfm, torch.Generator().manual_seed(0)))
    trainer.device = torch.device("cuda")       # only the dispatch reads it here
    calls = []
    done = (torch.zeros(1, 1), torch.zeros(1, M, 1))

    def fake(name):
        def run(*args, **kw):
            calls.append((name, kw.get("use_pallas", False)))
            return done
        return run

    monkeypatch.setattr(train_loop, "launch_scann_forward", fake("fused"))
    monkeypatch.setattr(train_loop, "launch_loop_forward", fake("loop"))
    monkeypatch.setattr(train_loop, "scann_forward", fake("per_layer"))
    batch = {"atomic": torch.zeros(1, M, dtype=torch.int32),
             "neighbors": torch.zeros(1, M, N, dtype=torch.int32)}
    assert trainer.eval_route(M, N) == route
    assert trainer.forward_eval(trainer.params, batch) is done
    assert calls == [(route, route == "per_layer")]


def test_torch_training_refuses_crystal_buckets_naming_the_loop_backward():
    """The molecule backward refuses a crystal bucket and names the route
    that trains it, the backward of the crystal loop kernel, which takes it."""
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_loop as kloop

    with pytest.raises(NotImplementedError, match="loop_scann_train_grads"):
        kbwd.check_supported(MP2018, 96, 32)
    assert "loop_scann_train_grads" in kbwd.refusal(MP2018, 96, 32)
    assert kloop.backward_refusal(MP2018, 96, 32) is None


def test_torch_local_attention_gate_and_flops():
    kla.check_supported(128, 32, 128, 8, torch.float32)
    kla.check_supported(128, 64, 20, 8, torch.float32)
    for bad in ((130, 32, 20, 8), (256, 32, 20, 8), (128, 72, 20, 8), (128, 32, 200, 8),
                (128, 32, 20, 7)):
        with pytest.raises(NotImplementedError, match="sizes"):
            kla.check_supported(*bad, torch.float32)
    with pytest.raises(NotImplementedError, match="float32"):
        kla.check_supported(128, 32, 128, 8, torch.bfloat16)
    x = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kla.launch_local_attention(x, None, None, None, None, {}, 4, 0.5, True)
    # one MP2018 layer (B=64, M=96, N=32, D=128): ~2.0e10 FLOP
    assert kla.layer_flops(64, 96, 32, 128, True) == pytest.approx(1.983e10, rel=1e-3)
    assert kla.layer_flops(64, 96, 32, 128, False) < kla.layer_flops(64, 96, 32, 128, True)
