"""The PyTorch port's ops against ``scann_tpu.ops`` on the CPU, in float32,
on the same seeded numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.ops import activations as jact
from scann_tpu.ops import attention as jatt
from scann_tpu.ops import rbf as jrbf
from scann_tpu_torch.ops import activations as tact
from scann_tpu_torch.ops import attention as tatt
from scann_tpu_torch.ops import rbf as trbf

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_torch_rbf_matches_jax():
    rng = np.random.default_rng(0)
    for stop in (4.0, 2 * np.pi):
        np.testing.assert_array_equal(trbf.make_centers(stop, 20), jrbf.make_centers(stop, 20))
    x = rng.uniform(0.0, 6.0, size=(3, 5, 4)).astype(np.float32)
    c = jrbf.make_centers(4.0, 20)
    _close(trbf.gaussian_expansion(torch.from_numpy(x), torch.from_numpy(c)),
           jrbf.gaussian_expansion(jnp.asarray(x), jnp.asarray(c)))


def test_torch_activations_match_jax():
    x = np.random.default_rng(1).normal(size=(64,)).astype(np.float32) * 4
    _close(tact.swish(torch.from_numpy(x)), jact.swish(jnp.asarray(x)))
    _close(tact.mrelu(torch.from_numpy(x)), jact.mrelu(jnp.asarray(x)))
    # straight-through: the gradient is the identity, as in the JAX custom_vjp
    t = torch.from_numpy(x).requires_grad_()
    tact.mrelu(t).sum().backward()
    _close(t.grad, jax.grad(lambda v: jact.mrelu(v).sum())(jnp.asarray(x)))


def test_torch_gather_matches_jax():
    rng = np.random.default_rng(2)
    states = rng.normal(size=(3, 7, 5)).astype(np.float32)
    idx = rng.integers(0, 7, size=(3, 7, 4)).astype(np.int32)
    _close(tatt.gather_neighbor_states(torch.from_numpy(states), torch.from_numpy(idx)),
           jatt.gather_neighbor_states(jnp.asarray(states), jnp.asarray(idx), strategy="take"),
           rtol=0, atol=0)


@pytest.mark.parametrize("scale", [0.5, 1.0])
def test_torch_local_attention_core_matches_jax(scale):
    rng = np.random.default_rng(3)
    B, M, N, D, H = 2, 6, 5, 16, 4
    q = rng.normal(size=(B, M, D)).astype(np.float32)
    k = rng.normal(size=(B, M, N, D)).astype(np.float32)
    mask = (rng.uniform(size=(B, M, N)) > 0.3).astype(np.float32)
    mask[..., 0] = 1.0
    mask[0, 0] = 0.0  # an atom with no neighbours (padding row)
    attn_t, ctx_t = tatt.local_attention_core(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
        torch.from_numpy(mask), num_head=H, scale=scale)
    attn_j, ctx_j = jatt.local_attention_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), jnp.asarray(mask),
        num_head=H, scale=scale)
    _close(attn_t, attn_j)
    _close(ctx_t, ctx_j)


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("single_atom", [False, True])
def test_torch_global_attention_core_matches_jax(norm, single_atom):
    rng = np.random.default_rng(4)
    B, M, G = 3, 8, 16
    q = rng.normal(size=(B, M, G)).astype(np.float32)
    k = rng.normal(size=(B, M, G)).astype(np.float32)
    mask = np.zeros((B, M, 1), np.float32)
    for b, n in enumerate((1, 5, 8) if single_atom else (3, 5, 8)):
        mask[b, :n] = 1.0
    attn_t, ctx_t = tatt.global_attention_core(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
        torch.from_numpy(mask), norm=norm)
    attn_j, ctx_j = jatt.global_attention_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), jnp.asarray(mask), norm=norm)
    _close(attn_t, attn_j)
    _close(ctx_t, ctx_j)
    assert torch.isfinite(attn_t).all()


def test_torch_global_attention_single_atom_gradient_finite():
    """The zero-norm guard wraps the sum before the sqrt: a single-atom
    structure gives finite gradients, like the JAX op."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(1, 4, 8)).astype(np.float32)).requires_grad_()
    k = torch.from_numpy(rng.normal(size=(1, 4, 8)).astype(np.float32)).requires_grad_()
    mask = torch.zeros(1, 4, 1)
    mask[0, 0] = 1.0
    attn, ctx = tatt.global_attention_core(q, k, k, mask, norm=True)
    (attn.sum() + ctx.sum()).backward()
    assert attn[0, 0, 0].item() == 1.0
    assert torch.isfinite(q.grad).all() and torch.isfinite(k.grad).all()
