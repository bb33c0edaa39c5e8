"""The PyTorch port's eager model and its whole-model kernel wrapper
against the JAX package on the CPU, in float32: the same flax parameters
(moved with ``params_from_jax``) and the same seeded inputs
(``conftest.make_synthetic_batch``)."""

import jax
import numpy as np
import pytest
import torch

from conftest import jit_apply, jit_init_vars, make_synthetic_batch
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.kernels.scann_forward import fused_scann_forward as jax_fused_forward
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu_torch.compat import params_from_jax
from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.models import ScannModel, init_params, param_shapes

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
SMALL = dict(n_atoms=10, embedding_dim=16, n_attention=2, local_dim=32,
             num_head=4, global_dim=32, dense_out=16)


def _configs(**kw):
    return JaxModelConfig(**SMALL, **kw), ModelConfig(**SMALL, **kw)


def _setup(rng, mrelu=False, B=3, M=12, N=6, **kw):
    jcfg, tcfg = _configs(**kw)
    inputs = make_synthetic_batch(rng, B=B, M=M, N=N, use_ring=tcfg.use_ring,
                                  cgcnn=tcfg.feature == "cgcnn")
    jmodel = JaxScannModel(config=jcfg, mrelu_head=mrelu)
    jparams = jit_init_vars(jmodel, jax.random.PRNGKey(0), inputs)
    tparams = params_from_jax(jax.device_get(jparams), tcfg)
    return jmodel, jparams, tcfg, tparams, inputs


def _torch_inputs(inputs):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}


GRID = [  # (g_update, ga_norm, mrelu, ring, cgcnn), as in test_kernels.py
    (True, True, False, False, False),
    (False, False, True, False, False),
    (True, False, False, False, False),
    (False, True, False, True, False),
    (True, True, False, False, True),
    (True, True, False, True, False),
]


@pytest.mark.parametrize("g_update,ga_norm,mrelu,ring,cgcnn", GRID)
def test_torch_model_matches_jax_model(rng, g_update, ga_norm, mrelu, ring, cgcnn):
    jmodel, jparams, tcfg, tparams, inputs = _setup(
        rng, mrelu=mrelu, g_update=g_update, use_ga_norm=ga_norm, use_ring=ring,
        feature="cgcnn" if cgcnn else "atomic")
    ref = jit_apply(jmodel)(jparams, inputs)
    with torch.no_grad():
        out = ScannModel(tcfg, mrelu_head=mrelu, params=tparams)(_torch_inputs(inputs))
        pred, ga = kfwd.fused_scann_forward(tparams, _torch_inputs(inputs), tcfg, mrelu)
    for got_p, got_g in ((out["property"], out["ga_score"]), (pred, ga)):
        np.testing.assert_allclose(got_p.numpy(), np.asarray(ref["property"]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_g.numpy(), np.asarray(ref["ga_score"]),
                                   rtol=RTOL, atol=ATOL)


def test_torch_fused_wrapper_matches_jax_fused_kernel(rng):
    """The port's wrapper on CPU tensors (its plain version) against the JAX
    whole-model Pallas kernel in interpret mode and the JAX flax model."""
    jmodel, jparams, tcfg, tparams, inputs = _setup(rng, g_update=True)
    jcfg = jmodel.config
    jpred, jga = jax_fused_forward(jparams, inputs, jcfg, interpret=True)
    ref = jit_apply(jmodel)(jparams, inputs)
    with torch.no_grad():
        pred, ga = kfwd.fused_scann_forward(tparams, _torch_inputs(inputs), tcfg)
    for want_p, want_g in ((jpred, jga), (ref["property"], ref["ga_score"])):
        np.testing.assert_allclose(pred.numpy(), np.asarray(want_p), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ga.numpy(), np.asarray(want_g), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("g_update,ring,cgcnn,attn_norm", [
    (True, False, False, True), (False, True, False, True),
    (True, False, True, True), (False, False, False, False)])
def test_torch_param_shapes_match_flax_init(rng, g_update, ring, cgcnn, attn_norm):
    jmodel, jparams, tcfg, _, _ = _setup(
        rng, g_update=g_update, use_ring=ring, use_attn_norm=attn_norm,
        feature="cgcnn" if cgcnn else "atomic")
    flat = jax.tree_util.tree_flatten_with_path(jparams["params"])[0]
    want = {"/".join(p.key for p in path): tuple(v.shape) for path, v in flat}
    assert param_shapes(tcfg) == want


def test_torch_init_params_keras_ranges():
    cfm = ModelConfig(**SMALL)
    p = init_params(cfm, torch.Generator().manual_seed(0))
    assert set(p) == set(param_shapes(cfm))
    emb = p["embed_atom/embedding"]
    assert emb.abs().max() <= 0.05 and emb.std() > 0.01
    k = p["local_attention_0/key/kernel"]
    limit = np.sqrt(6.0 / (32 + 32))
    assert k.abs().max() <= limit and k.abs().max() > 0.9 * limit
    assert (p["local_attention_0/key/bias"] == 0).all()
    assert (p["local_attention_0/layer_norm/scale"] == 1).all()
    again = init_params(cfm, torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_torch_kernel_gate():
    """Shapes and configs the CUDA kernel does not take raise
    NotImplementedError, naming what is missing."""
    cfm = ModelConfig()
    kfwd.check_supported(cfm, 32, 16)
    kfwd.check_supported(cfm, 64, 16)
    with pytest.raises(NotImplementedError, match="loop kernel"):
        kfwd.check_supported(cfm, 96, 32)
    with pytest.raises(NotImplementedError, match="use_attn_norm"):
        kfwd.check_supported(ModelConfig(use_attn_norm=False), 32, 16)
    with pytest.raises(NotImplementedError, match="sizes"):
        kfwd.check_supported(cfm, 32, 72)
    assert kfwd.shared_memory_plan(cfm, 64, 16)[2] <= kfwd.MAX_SHARED_BYTES


def test_torch_forward_flops_qm9():
    """~5.0e10 FLOP per QM9 serving batch (B=128, M=32, N=16), the count the
    kernel's bound is computed from."""
    f = kfwd.forward_flops(ModelConfig(), 128, 32, 16)
    assert 4.9e10 < f < 5.1e10
