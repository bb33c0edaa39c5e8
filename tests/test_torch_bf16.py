"""``model.dtype: bfloat16`` in the PyTorch port against the JAX package on
the CPU, at small sizes: ``kernels/dots.py`` shape for shape, the plain
versions of kernels #1 and #3 in the bf16 operand mode against the JAX
Pallas kernels in interpret mode (unpacked and packed), #5's plain version
against ``local_attention._pallas_forward`` on bfloat16 inputs, the eager
bf16 model against the flax bf16 model, ``Scann.predict_structure``, the
training rates the mode takes and a bf16 ``fit`` (the bf16 gradients are
in ``tests/test_torch_bf16_train.py``). Weights move across from the flax parameters
(``params_from_jax``), inputs come from seeded numpy.

Tolerances: JAX's own bf16 bound, rtol 0.05 and atol 0.02
(``tests/test_kernels.py:236``, ``tests/test_loop_kernels.py:76``), on every
output. For #1, #3 and #5 also: the mean absolute difference between the
port and JAX in bf16 is at most 0.1 x the mean absolute difference between
JAX in bf16 and JAX in f32 on the same inputs (``GAP``), which a port that
rounds nowhere, or in other places, does not meet. Both sides sum in f32 in
different orders, and where such a difference straddles a bfloat16
rounding boundary the two round one operand to neighbouring values (about
one element in 10^4 of the SCANN+ layers here); its effect on one small
molecule can reach the whole bf16-vs-f32 gap, so the means pool several
seeded batches of one shape.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import jit_apply, jit_init_vars, make_synthetic_batch
from scann_tpu.api import Scann as JaxScann
from scann_tpu.config import HyperConfig as JaxHyper
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.config import ScannConfig as JaxConfig
from scann_tpu.config import TpuConfig as JaxTpu
from scann_tpu.data.structure import Structure as JaxStructure
from scann_tpu.kernels import dots as jdots
from scann_tpu.kernels import local_attention as jla
from scann_tpu.kernels.scann_forward import fused_scann_forward as jax_fused_forward
from scann_tpu.kernels.scann_loop import loop_scann_forward as jax_loop_forward
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu_torch import api
from scann_tpu_torch.api import Scann
from scann_tpu_torch.compat import params_from_jax
from scann_tpu_torch.config import ModelConfig, ScannConfig
from scann_tpu_torch.data import packing
from scann_tpu_torch.data.structure import Structure
from scann_tpu_torch.kernels import dots
from scann_tpu_torch.kernels import local_attention as kla
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.models import ScannModel

torch.set_num_threads(1)

RTOL, ATOL = 0.05, 0.02
GAP = 0.1
BATCHES = 6          # seeded batches pooled into each gap
SMALL = dict(n_atoms=10, embedding_dim=16, n_attention=2, local_dim=32, num_head=4,
             global_dim=32, dense_out=16)


def _configs(**kw):
    return (JaxModelConfig(**SMALL, **kw), JaxModelConfig(**SMALL, **kw, dtype="bfloat16"),
            ModelConfig(**SMALL, **kw, dtype="bfloat16"))


def _torch(x):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}


def _flat(*arrays):
    return np.concatenate([np.ravel(np.asarray(a, np.float32)) for a in arrays])


def _assert_bf16(got, want, want_f32, gap=True):
    """``got`` (the port) within rtol/atol of ``want`` (JAX in bf16), each a
    list of outputs; with ``gap``, the pooled mean difference within GAP x
    JAX's bf16-vs-f32 mean difference."""
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                   rtol=RTOL, atol=ATOL)
    if gap:
        g, w, w32 = _flat(*got), _flat(*want), _flat(*want_f32)
        port, rounding = np.abs(g - w).mean(), np.abs(w - w32).mean()
        print(f"mean |port - JAX bf16| {port:.3e}, mean |JAX bf16 - JAX f32| {rounding:.3e}, "
              f"ratio {port / rounding:.4f}; max |port - JAX bf16| {np.abs(g - w).max():.3e}")
        assert rounding > 0
        assert port <= GAP * rounding, (port, rounding)


# --- kernels/dots.py ----------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
def test_torch_bf16_dots_match_jax(bf16):
    """The six contraction shapes and the two f32-exact ones against the JAX
    factory's: products of rounded operands, summed in f32 (rtol 1e-6 of the
    largest |term| sum: the sums run in another order)."""
    rng = np.random.default_rng(0)
    a2, b2 = rng.normal(size=(12, 20)), rng.normal(size=(20, 8))
    c2 = rng.normal(size=(12, 8))
    x3, w, wt = rng.normal(size=(6, 5, 20)), rng.normal(size=(20, 8)), rng.normal(size=(8, 20))
    dy = rng.normal(size=(6, 5, 8))
    cases = [((a2, b2), (a2, b2)), ((a2, c2), (a2, c2)), ((a2, b2.T), (a2, b2.T)),
             ((x3, w), (x3, w)), ((x3, wt), (x3, wt)), ((x3, dy), (x3, dy))]
    f32 = lambda a: np.asarray(a, np.float32)
    for port, jf_, (args, _) in zip(dots.dot_fns(bf16), jdots.dot_fns(bf16), cases):
        got = port(*[torch.from_numpy(f32(a)) for a in args]).numpy()
        want = np.asarray(jf_(*[jnp.asarray(f32(a)) for a in args]))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    for port, jf_, args in ((dots.mm_hi, jdots.mm_hi, (a2, b2)),
                            (dots.mm_tA_hi, jdots.mm_tA_hi, (a2, c2))):
        got = port(*[torch.from_numpy(f32(a)) for a in args]).numpy()
        want = np.asarray(jf_(*[jnp.asarray(f32(a)) for a in args]))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    want = np.array(jnp.asarray(f32(a2)).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(dots.round_bf16(torch.from_numpy(f32(a2))).numpy(), want)


# --- the plain versions of #1 and #3 in the bf16 operand mode --------------------

def _packed(x, capacity, slots=2, S=4):
    """``x`` packed into ``slots`` slots of ``capacity`` rows, the one-hot
    widened to ``S`` segments (static shapes for the jitted JAX kernels)."""
    p = packing.pack_padded_inputs(x, capacity=capacity, max_segments=S - 1)
    out = {k: np.ascontiguousarray(v[:slots]) for k, v in p.inputs.items()
           if k != "segment_mask"}
    seg = out["segment_onehot"]
    out["segment_onehot"] = np.concatenate(
        [seg, np.zeros(seg.shape[:2] + (S - seg.shape[2],), np.float32)], -1)
    return out


def _whole_model_case(kernel, port, M, N, packed, **kw):
    """(port outputs, JAX bf16 outputs, JAX f32 outputs) over BATCHES seeded
    batches of 2 structures (or 2 packed slots) at (M, N)."""
    jcfg, jcfg16, tcfg = _configs(**kw)
    extra = {"batch_tile": 1} if kernel is jax_fused_forward else {}
    run32 = jax.jit(lambda v, x: kernel(v, x, jcfg, interpret=True, **extra))
    run16 = jax.jit(lambda v, x: kernel(v, x, jcfg16, interpret=True, **extra))
    got, want, want32 = [], [], []
    for seed in range(BATCHES):
        rng = np.random.default_rng(seed)
        if packed:
            x = _packed(make_synthetic_batch(rng, B=8, M=M // 2, N=N), capacity=M)
        else:
            x = make_synthetic_batch(rng, B=2, M=M, N=N)
        jvars = jax.device_get(jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(seed),
                                             x))
        tparams = params_from_jax(jvars, tcfg)
        with torch.no_grad():
            got += [t.numpy() for t in port(tparams, _torch(x), tcfg)]
        want += [np.asarray(t) for t in run16(jvars, x)]
        want32 += [np.asarray(t) for t in run32(jvars, x)]
    return got, want, want32


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("g_update", [True, False])
def test_torch_bf16_molecule_plain_matches_jax_kernel(packed, g_update):
    """#1's plain version in bf16 (``reference_bf16_forward``, exact segment
    pools) against ``scann_forward.py:_kernel`` at model.dtype bfloat16, B=2,
    M=12, N=6, L=2, D=32 (packed: 2 slots of 12 rows, S=4)."""
    _assert_bf16(*_whole_model_case(jax_fused_forward, kfwd.fused_scann_forward, 12, 6, packed,
                                    g_update=g_update))


@pytest.mark.parametrize("packed", [False, True])
def test_torch_bf16_loop_plain_matches_jax_kernel(packed):
    """#3's plain version in bf16 (the loop kernel's bf16-mode segment pools
    and per-segment max) against ``scann_loop.py:_fwd_kernel`` at B=2, M=24,
    N=8, L=2 (packed: 2 slots of 24 rows, S=4)."""
    _assert_bf16(*_whole_model_case(jax_loop_forward, kloop.loop_scann_forward, 24, 8, packed,
                                    g_update=True))


def test_torch_bf16_f32_plain_is_still_the_eager_model():
    """In f32 the plain versions of #1 and #3 are the eager model, bit for bit."""
    jcfg, _, tcfg = _configs(g_update=True)
    tcfg = dataclasses.replace(tcfg, dtype="float32")
    x = make_synthetic_batch(np.random.default_rng(3), B=2, M=12, N=6)
    tparams = params_from_jax(jax.device_get(jit_init_vars(
        JaxScannModel(config=jcfg), jax.random.PRNGKey(3), x)), tcfg)
    with torch.no_grad():
        eager = ScannModel(tcfg, params=tparams)(_torch(x))
        for fn in (kfwd.fused_scann_forward, kloop.loop_scann_forward):
            pred, ga = fn(tparams, _torch(x), tcfg)
            assert torch.equal(pred, eager["property"]) and torch.equal(ga, eager["ga_score"])


def test_torch_bf16_whole_model_refuses_training_rates():
    """The bf16 operand mode trains too, so its training forward takes a
    dropout rate above 0 (the plain versions of #1 and #3 apply the
    kernels' masks), the launch flag follows the dtype alone, and only a
    dtype the kernels do not take (float16) is refused, by the forwards' and
    the backwards' gates alike."""
    _, _, tcfg = _configs(g_update=True)
    x = _torch(make_synthetic_batch(np.random.default_rng(2), B=2, M=8, N=4))
    params = ScannModel(tcfg, generator=torch.Generator().manual_seed(2)).params
    params = {k: v.data for k, v in params.items()}
    with torch.no_grad():
        for plain in (kfwd.reference_scann_forward, kloop.reference_loop_forward):
            dropped, _ = plain(params, x, tcfg, False, 0.1, 3)
            kept, _ = plain(params, x, tcfg)
            assert torch.isfinite(dropped).all() and not torch.equal(dropped, kept)
    assert kfwd.operand_mode(tcfg) == 1
    assert kfwd.operand_mode(dataclasses.replace(tcfg, dtype="float32")) == 0
    f16 = dataclasses.replace(tcfg, dtype="float16")
    for reason in (kfwd.refusal(f16, 8, 4), kloop.refusal(f16, 8, 4),
                   kbwd.refusal(f16, 8, 4), kloop.backward_refusal(f16, 8, 4)):
        assert "'float16'" in reason
    assert kbwd.refusal(tcfg, 8, 4) is None and kloop.backward_refusal(tcfg, 8, 4) is None


# --- #5 on bfloat16 tensors -----------------------------------------------------

@pytest.mark.parametrize("g_update", [True, False])
def test_torch_bf16_local_attention_plain_matches_jax_kernel(g_update):
    """#5's plain version (``reference_layer_kernel``: f32 inside, bfloat16
    outputs) on bfloat16 tensors against ``_pallas_forward`` on the same
    bfloat16 inputs in interpret mode, and the gap against it on the f32
    originals."""
    B, M, N, D, H, K = 2, 12, 6, 32, 4, 20
    run = jax.jit(lambda c, i, g, m, w, p: jla._pallas_forward(
        c, i, g, m, w, p, H, 0.5, g_update, interpret=True))
    got, want, want32 = [], [], []
    for seed in range(BATCHES):
        rng = np.random.default_rng(seed)
        mask = (rng.uniform(size=(B, M, N)) > 0.25).astype(np.float32)
        mask[..., 0] = 1.0
        arrays = {"centers": rng.normal(size=(B, M, D)),
                  "geometry": rng.normal(size=(B, M, N, D if g_update else K)),
                  "mask": mask, "weight": rng.uniform(0.3, 3.0, size=(B, M, N))}
        params = {"filter_geo/kernel": 0.1 * rng.normal(size=(3 * D if g_update else K, D)),
                  "filter_geo/bias": 0.1 * rng.normal(size=D),
                  "key/kernel": 0.1 * rng.normal(size=(D, D)), "key/bias": 0.1 * rng.normal(size=D),
                  "query/kernel": 0.1 * rng.normal(size=(D, D)),
                  "query/bias": 0.1 * rng.normal(size=D),
                  "layer_norm/scale": rng.uniform(0.5, 1.5, size=D),
                  "layer_norm/bias": 0.1 * rng.normal(size=D)}
        if g_update:
            params["layer_norm_g/scale"] = rng.uniform(0.5, 1.5, size=D)
            params["layer_norm_g/bias"] = 0.1 * rng.normal(size=D)
        idx = rng.integers(0, M, size=(B, M, N)).astype(np.int32)

        def nest(p):
            out = {}
            for k, v in p.items():
                mod, leaf = k.split("/")
                out.setdefault(mod, {})[leaf] = v
            return out

        def jax_run(dtype):
            j = lambda a: jnp.asarray(np.asarray(a, np.float32)).astype(dtype)
            return run(j(arrays["centers"]), jnp.asarray(idx), j(arrays["geometry"]),
                       j(arrays["mask"]), None if g_update else j(arrays["weight"]),
                       jax.tree.map(j, nest(params)))

        bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
        with torch.no_grad():
            out, geo, attn = kla.fused_local_attention(
                bf(arrays["centers"]), torch.from_numpy(idx), bf(arrays["geometry"]),
                bf(arrays["mask"]), None if g_update else bf(arrays["weight"]),
                {k: bf(v) for k, v in params.items()}, H, 0.5, g_update)
        assert out.dtype == attn.dtype == geo.dtype == torch.bfloat16
        j16, j32 = jax_run(jnp.bfloat16), jax_run(jnp.float32)
        keep = 3 if g_update else 1           # SCANN passes its geometry through
        got += [t.float().numpy() for t in (out, attn, geo)[:keep]]
        want += [np.asarray(t, np.float32) for t in (j16[0], j16[2], j16[1])[:keep]]
        want32 += [np.asarray(t) for t in (j32[0], j32[2], j32[1])[:keep]]
    _assert_bf16(got, want, want32)


# --- the eager bf16 model and the entry points -----------------------------------

@pytest.mark.parametrize("g_update", [True, False])
def test_torch_bf16_eager_model_matches_flax_model(g_update):
    """The eager model at model.dtype bfloat16 (the flax modules' dtypes, op
    by op) against ``ScannModel(config=cfg_bf16).apply``; each side rounds its
    elementwise ops in its own places, so the bound is JAX's bf16 one."""
    jcfg, jcfg16, tcfg = _configs(g_update=g_update)
    x = make_synthetic_batch(np.random.default_rng(5), B=3, M=12, N=6)
    jvars = jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(5), x)
    want = jit_apply(JaxScannModel(config=jcfg16))(jvars, x)
    tparams = params_from_jax(jax.device_get(jvars), tcfg)
    with torch.no_grad():
        got = ScannModel(tcfg, params=tparams)(_torch(x))
    for k in ("property", "ga_score"):
        assert got[k].dtype == torch.float32
        _assert_bf16([got[k].numpy()], [want[k]], None, gap=False)


def test_torch_bf16_predict_structure_matches_jax(tmp_path, monkeypatch):
    """``Scann(cfg_bf16, device="cpu").predict_structure`` against the JAX
    package's bf16 prediction on the same molecule (standardized value and
    GA scores), and the one-time canonical-frame INFO line of
    ``scann_tpu/api.py:66-80``."""
    monkeypatch.setenv("SCANN_TPU_NATIVE_VORONOI", "0")
    mol = (["C", "O", "H", "H"], [[0, 0, 0], [1.21, 0, 0], [-0.55, 0.94, 0], [-0.55, -0.94, 0]])
    jcfg = JaxConfig(model=JaxModelConfig(**SMALL, g_update=True, dtype="bfloat16"),
                     hyper=JaxHyper(batch_size=2, target="homo", target_mean=-0.2,
                                    target_std=0.03, save_path=str(tmp_path / "jax")),
                     tpu=JaxTpu(use_pallas=False))
    js = JaxScann(jcfg)
    js.trainer.init_state(js._example_inputs(), seed=4)
    ts = Scann(ScannConfig.from_dict(dataclasses.asdict(jcfg)), device="cpu")
    ts.load_params(jax.device_get(js.trainer.state.params))
    jv, jga = js.predict_structure(JaxStructure(*mol))
    monkeypatch.setattr(api, "_CANONICAL_NOTICE_EMITTED", [False])
    with pytest.MonkeyPatch.context() as mp:
        records = []
        mp.setattr(logging.getLogger(api.__name__), "info",
                   lambda msg, *a: records.append(msg % a if a else msg))
        v, ga = ts.predict_structure(Structure(*mol))
        ts.predict_structure(Structure(*mol))
    assert len(records) == 1 and "canonical_frame" in records[0] and "CHANGELOG" in records[0]
    std = lambda val: (val - jcfg.hyper.target_mean) / jcfg.hyper.target_std
    _assert_bf16([np.float32(std(v)), ga], [np.float32(std(jv)), jga], None, gap=False)


def test_torch_bf16_canonical_notice_matches_jax(caplog):
    """The port's notice against the JAX one: once, on molecules only, the
    same text."""
    from scann_tpu import api as jax_api

    crystal = Structure(["Fe"], [[0.0, 0.0, 0.0]], lattice=np.eye(3) * 3.0)
    mol = Structure(["C", "O"], [[0, 0, 0], [1.13, 0, 0]])
    jmol = JaxStructure(["C", "O"], [[0, 0, 0], [1.13, 0, 0]])
    saved = api._CANONICAL_NOTICE_EMITTED[0], jax_api._CANONICAL_NOTICE_EMITTED[0]
    api._CANONICAL_NOTICE_EMITTED[0] = jax_api._CANONICAL_NOTICE_EMITTED[0] = False
    try:
        with caplog.at_level(logging.INFO):
            api._canonical_frame_notice([crystal])
            assert not caplog.records
            api._canonical_frame_notice([crystal, mol])
            api._canonical_frame_notice([mol])
            jax_api._canonical_frame_notice([jmol])
        assert [r.name for r in caplog.records] == [api.__name__, jax_api.__name__]
        assert caplog.records[0].getMessage() == caplog.records[1].getMessage()
    finally:
        api._CANONICAL_NOTICE_EMITTED[0], jax_api._CANONICAL_NOTICE_EMITTED[0] = saved


def test_torch_bf16_training_raises_naming_the_next_slice(tmp_path):
    """``Trainer.fit`` (and ``Scann.train``) at model.dtype bfloat16 take
    their steps, the backward kernels having the bf16 operand mode: a finite
    loss, one step a batch, f32 params that moved, and ``raw_grads`` gives
    an f32 gradient for every parameter."""
    from scann_tpu_torch.data.pipeline import PackedBucket

    ts = Scann(ScannConfig(model=ModelConfig(**SMALL, dtype="bfloat16")), device="cpu",
               workdir=str(tmp_path / "run"))
    ts.init_params(seed=0)
    before = {k: v.clone() for k, v in ts.trainer.params.items()}
    x = make_synthetic_batch(np.random.default_rng(0), B=4, M=8, N=4)
    bucket = PackedBucket(x, np.linspace(-1, 1, 4).astype(np.float32), np.arange(4))
    hist = ts.trainer.fit([bucket], [bucket], epochs=1, log_fn=lambda *_: None)
    assert np.isfinite(hist["loss"]).all() and ts.trainer.step == 1
    assert all(v.dtype == torch.float32 for v in ts.trainer.params.values())
    assert any(not torch.equal(v, before[k]) for k, v in ts.trainer.params.items())
    _, raw = ts.trainer.raw_grads(_torch(x), torch.zeros(4), 0)
    assert set(raw) == set(before) and all(g.dtype == torch.float32 and torch.isfinite(g).all()
                                           for g in raw.values())
    ts.train_buckets, ts.valid_buckets = [bucket], [bucket]
    assert np.isfinite(ts.train(epochs=1)["loss"]).all()


def test_torch_bf16_weights_stay_f32_across_packages(tmp_path):
    """Params stay f32 in both packages at model.dtype bfloat16, so weights
    carried from the JAX package and the H5 export need no change: the same
    tree moves across at either dtype, and an exported H5 reads back into a
    bf16 model bit for bit."""
    from scann_tpu_torch.compat.h5_loader import load_h5_params

    jcfg, jcfg16, tcfg = _configs(g_update=True)
    x = make_synthetic_batch(np.random.default_rng(1), B=2, M=8, N=4)
    jvars = jax.device_get(jit_init_vars(JaxScannModel(config=jcfg16), jax.random.PRNGKey(1), x))
    assert all(np.asarray(v).dtype == np.float32 for v in jax.tree.leaves(jvars))
    p16 = params_from_jax(jvars, tcfg)
    p32 = params_from_jax(jvars, dataclasses.replace(tcfg, dtype="float32"))
    assert set(p16) == set(p32)
    assert all(v.dtype == torch.float32 and torch.equal(v, p32[k]) for k, v in p16.items())
    ts = Scann(ScannConfig(model=tcfg), device="cpu", workdir=str(tmp_path / "run"))
    ts.load_params(jvars)
    back = params_from_jax(load_h5_params(ts.export_h5(str(tmp_path / "w.h5")), tcfg), tcfg)
    assert all(torch.equal(back[k], p16[k]) for k in p16)
