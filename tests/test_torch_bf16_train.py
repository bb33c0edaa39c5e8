"""``model.dtype: bfloat16`` training in the PyTorch port against the JAX
package on the CPU, at small sizes (D=32, 4 heads, L=2): the plain versions
of the backward kernels #2 and #4 in the bf16 operand mode against the JAX
Pallas backward kernels in interpret mode (unpacked and packed), the
cotangent's rounding before the one-hot sums, the per-layer route's bf16
trajectory against the JAX Trainer's XLA step on the flax bf16 model, two
gloo ranks against ordered shards, ``Scann.train`` end to end, and the
dropout masks of the bf16 training forward. Weights move across from the
flax parameters (``params_from_jax``), inputs come from seeded numpy.

Tolerances of a gradient case (``_hold``), over ``BATCHES`` seeded batches
of one shape, on all gradients of a batch flattened into one vector:
- the cosine with JAX's f32 gradient above 0.999 in every batch, JAX's own
  check (``tests/test_kernels.py:273``, ``tests/test_loop_kernels.py:101``),
  or where JAX's own bf16 gradient reads below that (random weights without
  ga_norm: 0.99880 and 0.99602 in two batches of the mrelu case), no more
  than 1e-4 below JAX's own reading;
- the median over the batches of the mean absolute difference from JAX's
  bf16 gradient at most 0.1 x JAX's own bf16-vs-f32 mean difference
  (``GAP``), as ``test_torch_bf16.py`` holds the forwards;
- the pooled mean difference below the one the port's f32 plain gradient
  reads against JAX's bf16 gradient: what a port that skipped the mode reads.

A median, not a pooled mean, because the bf16 result is chaotic in the f32
sum order: where the two sides' f32 sums straddle a bfloat16 rounding
boundary they round one operand to neighbouring values, and everything
downstream then rounds its own way. In a batch without such a flip the port
lies within 1e-3 x the gap of JAX; in one with a flip anywhere from 0.01 to
0.6 x, and JAX itself moves as far when its weights move by 1e-7 of their
size. A port that rounds in other places is off in every batch.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import jit_init_vars, make_synthetic_batch
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.kernels.scann_backward import fused_scann_grad as jax_fused_grad
from scann_tpu.kernels.scann_backward import fused_scann_train_grads as jax_train_grads
from scann_tpu.kernels.scann_loop import loop_scann_grad as jax_loop_grad
from scann_tpu.kernels.scann_loop import loop_scann_train_grads as jax_loop_train_grads
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu.models.scann import l2_penalty as jax_l2_penalty
from scann_tpu_torch.api import Scann
from scann_tpu_torch.compat import params_from_jax
from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig, TpuConfig
from scann_tpu_torch.data import packing
from scann_tpu_torch.kernels import dots
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.models.scann import param_shapes, scann_forward
from scann_tpu_torch.train import loop

torch.set_num_threads(1)

GAP = 0.1
COSINE = 0.999
BATCHES = 5          # seeded batches of one shape a gradient case holds
RTOL, ATOL = 0.05, 0.02      # JAX's own bf16 bound (tests/test_kernels.py:236)
SMALL = dict(n_atoms=10, embedding_dim=16, n_attention=2, local_dim=32, num_head=4,
             global_dim=32, dense_out=16)
# (g_update, ga_norm, mrelu, ring, cgcnn), from tests/test_torch_backward.py's grid
GRID = [
    (True, True, False, False, False),
    (False, False, True, False, False),
    (False, True, False, True, False),
    (True, True, False, False, True),
]


def _torch(x):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}


def _setup(seed, B, M, N, packed=False, mrelu=False, **kw):
    """(JAX f32 and bf16 configs, the port's bf16 config, JAX params, the
    port's params, numpy inputs, torch inputs)."""
    jcfg = JaxModelConfig(**SMALL, **kw)
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    tcfg = ModelConfig(**SMALL, **kw, dtype="bfloat16")
    rng = np.random.default_rng(seed)
    ring, cgcnn = tcfg.use_ring, tcfg.feature == "cgcnn"
    if packed:
        x = make_synthetic_batch(rng, B=4 * B, M=M // 2, N=N, use_ring=ring, cgcnn=cgcnn)
        p = packing.pack_padded_inputs(x, capacity=M, max_segments=3)
        x = {k: np.ascontiguousarray(v[:B]) for k, v in p.inputs.items() if k != "segment_mask"}
        seg = x["segment_onehot"]        # widened to S=4: every slot has an empty segment
        x["segment_onehot"] = np.concatenate(
            [seg, np.zeros(seg.shape[:2] + (4 - seg.shape[2],), np.float32)], -1)
    else:
        x = make_synthetic_batch(rng, B=B, M=M, N=N, use_ring=ring, cgcnn=cgcnn)
    jparams = jax.device_get(jit_init_vars(JaxScannModel(config=jcfg, mrelu_head=mrelu),
                                           jax.random.PRNGKey(seed), x))
    return jcfg, jcfg16, tcfg, jparams, params_from_jax(jparams, tcfg), x, _torch(x)


def _flat(grads):
    """A gradient dict (the port's, keyed like its params) or tree (JAX's) as
    one f64 vector in sorted key order."""
    if not isinstance(grads, dict) or not all(isinstance(v, torch.Tensor)
                                              for v in grads.values()):
        grads = {"/".join(p.key for p in path): np.asarray(v)
                 for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return np.concatenate([np.ravel(np.asarray(grads[k], np.float64)) for k in sorted(grads)])


def _hold(run, label):
    """``run(seed)`` -> (port bf16, port f32, JAX bf16, JAX f32) gradients
    of one seeded batch; the holds of the module docstring over
    ``BATCHES`` batches. Returns the per-batch ratios to the gap."""
    ratios, port_sum, skip_sum = [], 0.0, 0.0
    cos = lambda a, b: a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    for seed in range(BATCHES):
        p16, p32, j16, j32 = (_flat(g) for g in run(seed))
        assert p16.shape == j16.shape == j32.shape == p32.shape
        assert np.isfinite(p16).all()
        gap = np.abs(j16 - j32).mean()
        mine, own = cos(p16, j32), cos(j16, j32)
        assert gap > 0 and mine > min(COSINE, own - 1e-4), (seed, mine, own)
        ratios.append(np.abs(p16 - j16).mean() / gap)
        port_sum += np.abs(p16 - j16).mean()
        skip_sum += np.abs(p32 - j16).mean()
    print(f"{label}: mean |port bf16 - JAX bf16| / JAX's bf16-vs-f32 gap per batch "
          f"{np.round(ratios, 4).tolist()}, median {np.median(ratios):.4f}; pooled "
          f"{port_sum / skip_sum:.4f} x the port's f32 gradient's distance")
    assert np.median(ratios) <= GAP, ratios
    assert port_sum < skip_sum, (port_sum, skip_sum)
    return ratios


# --- kernel #2: the molecule backward ---------------------------------------------

_JITTED = {}


def _jitted(key, make):
    """One jitted JAX kernel function per (kernel, config) key for the whole
    module, so cases that share a config share its compilation."""
    if key not in _JITTED:
        _JITTED[key] = jax.jit(make())
    return _JITTED[key]


def _molecule_run(packed=False, cotangent=False, mrelu=False, **kw):
    """``_hold``'s ``run`` for #2: B=3, M=12, N=6 (packed: one slot of 12 rows,
    S=4 with empty segments); one-shot training gradients, or with
    ``cotangent`` those of (pred, ga) contracted with seeded cotangents."""
    jax_fns = {}

    def run(seed):
        jcfg, jcfg16, tcfg, jp, tp, x, tx = _setup(seed, 1 if packed else 3, 12, 6, packed,
                                                   mrelu, **kw)
        key = lambda c: (cotangent, mrelu, repr(c))
        f32 = dataclasses.replace(tcfg, dtype="float32")
        B, S = x["atomic"].shape[0], 4 if packed else 1
        rng = np.random.default_rng(100 + seed)
        if cotangent:
            args = (rng.normal(size=(B, S)).astype(np.float32),
                    rng.normal(size=(B, 12, 1)).astype(np.float32))
            for c in (jcfg16, jcfg):
                jax_fns[c.dtype] = _jitted(key(c), lambda c=c: lambda p, x, ct, cg: jax_fused_grad(
                    p, x, c, ct, cg, interpret=True, batch_tile=1))
            port = [kbwd.fused_scann_grad(tp, tx, c, *map(torch.from_numpy, args))
                    for c in (tcfg, f32)]
        else:
            args = (rng.normal(size=(B, S)).astype(np.float32),)
            for c in (jcfg16, jcfg):
                jax_fns[c.dtype] = _jitted(key(c), lambda c=c: lambda p, x, y: jax_train_grads(
                    p, x, y, c, mrelu_head=mrelu, interpret=True, batch_tile=1))
            outs = [kbwd.fused_scann_train_grads(tp, tx, torch.from_numpy(args[0]), c, mrelu)
                    for c in (tcfg, f32)]
            jpred, _ = jax_fns["bfloat16"](jp, x, *args)
            np.testing.assert_allclose(outs[0][0].numpy(), np.asarray(jpred), rtol=RTOL,
                                       atol=ATOL)
            port = [o[1] for o in outs]
        want = [jax_fns[c.dtype](jp, x, *args) for c in (jcfg16, jcfg)]
        if not cotangent:
            want = [w[1] for w in want]
        return (*port, *want)

    return run


@pytest.mark.parametrize("g_update,ga_norm,mrelu,ring,cgcnn", GRID)
def test_torch_bf16_molecule_train_grads_match_jax_kernel(g_update, ga_norm, mrelu, ring, cgcnn):
    """The one-shot training gradients of #2's plain version in bf16 against
    ``fused_scann_train_grads(..., cfg_bf16, interpret=True, batch_tile=1)``
    at B=3, M=12, N=6; pred within JAX's bf16 bound."""
    _hold(_molecule_run(mrelu=mrelu, g_update=g_update, use_ga_norm=ga_norm, use_ring=ring,
                        feature="cgcnn" if cgcnn else "atomic"), "#2 train")


@pytest.mark.parametrize("g_update", [True, False])
def test_torch_bf16_molecule_packed_and_cotangent_grads_match_jax_kernel(g_update):
    """#2's plain version in bf16 on packed slots (one slot of 12 rows a
    batch, S=4 with empty segments; pools f32-exact,
    ``scann_backward.py:296-300``) in one-shot mode, and unpacked with a GA
    cotangent (``fused_scann_grad``), against the JAX kernel."""
    _hold(_molecule_run(packed=True, g_update=g_update), "#2 packed train")
    _hold(_molecule_run(cotangent=True, g_update=g_update), "#2 cotangent")


# --- kernel #4: the crystal loop backward --------------------------------------------

@pytest.mark.parametrize("case", ["scann+", "scann ring", "packed", "cotangent"])
def test_torch_bf16_loop_grads_match_jax_kernel(case):
    """#4's plain version in bf16 (the loop kernel's bf16-mode segment pools
    and per-segment max for a packed slot, ``scann_loop.py:636-714``)
    against ``loop_scann_train_grads`` / ``loop_scann_grad(...,
    cfg_bf16, interpret=True)`` at B=2, M=24, N=8 (packed: one slot of 24
    rows, S=4)."""
    kw = dict(g_update=case != "scann ring", use_ring=case == "scann ring")
    jax_fns = {}

    def run(seed):
        packed = case == "packed"
        jcfg, jcfg16, tcfg, jp, tp, x, tx = _setup(seed, 1 if packed else 2, 24, 8, packed, **kw)
        f32 = dataclasses.replace(tcfg, dtype="float32")
        B = x["atomic"].shape[0]
        rng = np.random.default_rng(200 + seed)
        if case == "cotangent":
            args = (rng.normal(size=(B, 1)).astype(np.float32),
                    rng.normal(size=(B, 24, 1)).astype(np.float32))
            for c in (jcfg16, jcfg):
                jax_fns.setdefault(c.dtype, jax.jit(lambda p, x, ct, cg, c=c: jax_loop_grad(
                    p, x, c, ct, cg, interpret=True)))
            want = [jax_fns[c.dtype](jp, x, *args) for c in (jcfg16, jcfg)]
            port = [kloop.loop_scann_grad(tp, tx, c, *map(torch.from_numpy, args))
                    for c in (tcfg, f32)]
            return (*port, *want)
        y = rng.normal(size=(B, 4 if packed else 1)).astype(np.float32)
        for c in (jcfg16, jcfg):
            jax_fns.setdefault(c.dtype, jax.jit(lambda p, x, y, c=c: jax_loop_train_grads(
                p, x, y, c, interpret=True)))
        want = [jax_fns[c.dtype](jp, x, y) for c in (jcfg16, jcfg)]
        outs = [kloop.loop_scann_train_grads(tp, tx, torch.from_numpy(y), c) for c in (tcfg, f32)]
        np.testing.assert_allclose(outs[0][0].numpy(), np.asarray(want[0][0]).reshape(B, -1),
                                   rtol=RTOL, atol=ATOL)
        return outs[0][1], outs[1][1], want[0][1], want[1][1]

    _hold(run, f"#4 {case}")


# --- where the cotangent is rounded ---------------------------------------------------

@pytest.mark.parametrize("point", ["gather_t", "dattn"])
def test_torch_bf16_cotangent_rounds_before_the_one_hot_sums(point, monkeypatch):
    """The TPU kernels sum rounded cotangent rows where the port sums without
    a product: the neighbour gather's transpose (``scann_backward.py:152-156``)
    and d attention's head sum (``dattn = dot3(dal3, seg_sum)``, l.446). With
    the rounding moved after that sum (``dots.one_hot`` patched for the one
    point) the plain #2 gradient's median distance leaves 0.1 x JAX's
    bf16-vs-f32 gap, which the right placement keeps (SCANN+, B=3, M=12,
    N=6)."""
    run = _molecule_run(g_update=True)
    _hold(run, "rounded before the sums")

    class Late(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v, fwd, bwd):
            ctx.bwd = bwd
            return fwd(dots.round_bf16(v))

        @staticmethod
        def backward(ctx, g):
            return dots.round_bf16(ctx.bwd(g)), None, None

    one_hot = dots.one_hot

    def patched(v, fwd, bwd):
        out = one_hot(v, fwd, bwd)
        gather = v.dim() == 3 and out.dim() == 4              # [B, M, D] -> [B, M, N, D]
        lanes = v.dim() == 4 and out.shape[-1] > v.shape[-1]  # [.., H] -> [.., D]
        if (point == "gather_t" and gather) or (point == "dattn" and lanes):
            return Late.apply(v, fwd, bwd)
        return out

    monkeypatch.setattr(dots, "one_hot", patched)
    moved = []
    for seed in range(BATCHES):
        late, _, j16, j32 = (_flat(g) for g in run(seed))
        moved.append(np.abs(late - j16).mean() / np.abs(j16 - j32).mean())
    print(f"{point} rounded after its sum: per batch {np.round(moved, 4).tolist()}")
    assert np.median(moved) > GAP, moved


# --- the Trainer's bf16 routes ---------------------------------------------------------

def test_torch_bf16_per_layer_trajectory_matches_jax_trainer_step(monkeypatch):
    """20 Adam steps of the port's per-layer route at model.dtype bfloat16
    and dropout 0 (the eager model in the flax bf16 semantics under
    ``torch.autograd``; the kernels' gates shut) against the JAX Trainer's
    XLA step, ``jax.value_and_grad`` of the flax bf16 model's RMSE + l2
    (``scann_tpu/train/loop.py:371-377, 429``): the losses within JAX's bf16
    bound (rtol 0.05) and falling, params and Adam state f32 in both."""
    monkeypatch.setattr(loop.kbwd, "refusal", lambda *a, **k: "shut for this test")
    monkeypatch.setattr(loop.kloop, "backward_refusal", lambda *a, **k: "shut for this test")
    jcfg16 = JaxModelConfig(**SMALL, dtype="bfloat16")
    tcfg = ModelConfig(**SMALL, dtype="bfloat16")
    data = make_synthetic_batch(np.random.default_rng(9), B=12, M=12, N=6)
    y_all = np.linspace(-1.5, 1.5, 12).astype(np.float32)
    model = JaxScannModel(config=jcfg16)
    jparams = jit_init_vars(model, jax.random.PRNGKey(0), data)["params"]
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-7)

    @jax.jit
    def jax_step(params, opt, batch, y, lr):
        def loss_fn(p):
            pred = model.apply({"params": p}, batch, deterministic=True)["property"][:, 0]
            return jnp.sqrt(jnp.mean((pred - y) ** 2)) + jax_l2_penalty(p, 1e-4)

        loss, g = jax.value_and_grad(loss_fn)(params)
        upd, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, jax.tree.map(lambda u: -lr * u, upd)), opt, loss

    trainer = loop.Trainer(ScannConfig(model=tcfg, hyper=HyperConfig(batch_size=4)), "cpu")
    trainer.load_params(params_from_jax(jax.device_get(jparams), tcfg))
    trainer.dropout_rate = 0.0
    assert trainer.train_route(12, 6) == "per_layer"
    opt = tx.init(jparams)
    plan = np.random.default_rng(1)
    got, want = [], []
    for step in range(20):
        idx = plan.choice(12, size=4, replace=False)
        lr = 5e-4 / (1.0 + 1e-5 * step)
        batch = {k: v[idx] for k, v in data.items()}
        jparams, opt, jloss = jax_step(jparams, opt, batch, jnp.asarray(y_all[idx]), lr)
        loss, _ = trainer.train_step(_torch(batch), torch.from_numpy(y_all[idx]), lr, seed=0)
        got.append(float(loss))
        want.append(float(jloss))
    print("per-layer bf16 losses", got, "JAX", want,
          "max rel", max(abs(a - b) / abs(b) for a, b in zip(got, want)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[-1] < got[0] and want[-1] < want[0]
    assert all(v.dtype == torch.float32 for d in (trainer.params, trainer.mu, trainer.nu)
               for v in d.values())
    assert all(np.asarray(v).dtype == np.float32 for v in jax.tree.leaves(jparams))


def test_torch_bf16_two_gloo_ranks_train_as_ordered_shards(tmp_path):
    """Two gloo ranks (``tests/torch_distributed_worker.py``) train the bf16
    model: steps on the "fused" and the "loop" route (#2 and #4 in the bf16
    mode, their plain versions here) through ``make_sharded_scann_train`` /
    ``make_sharded_loop_train``, a one-epoch fit at dropout 0.1 and the five
    ``make_sharded_*`` wrappers; every loss, weight, prediction and gradient
    equals, bit for bit, one process running the same shards in rank order,
    as ``test_torch_distributed.py`` holds f32."""
    from test_torch_distributed import _free_port, _run_workers

    tiny = dict(SMALL, embedding_dim=8, dtype="bfloat16")
    rng = np.random.default_rng(7)
    tcfg = ModelConfig(**tiny)
    fused = make_synthetic_batch(rng, B=32, M=16, N=8)
    crystal = make_synthetic_batch(rng, B=32, M=72, N=8)
    jcfg = JaxModelConfig(**{k: v for k, v in tiny.items() if k != "dtype"})
    jparams = jax.device_get(jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(0),
                                           fused)["params"])
    data = {"model": json.dumps(tiny), "lrs": np.array([5e-4, 4e-4, 5e-4, 3e-4]),
            "seeds": np.array([11, 12])}
    for name, x in (("fused", fused), ("loop", crystal)):
        data.update({f"{name}/{k}": v for k, v in x.items()})
        data[f"{name}_targets"] = rng.normal(size=32).astype(np.float32)
        data[f"{name}_rows"] = np.stack([rng.permutation(32)[:16] for _ in range(2)])
    data.update({f"param/{k}": v.numpy() for k, v in params_from_jax(jparams, tcfg).items()})
    np.savez(tmp_path / "data.npz", **data)
    port = _free_port()
    common = {"data": tmp_path / "data.npz", "workdir": tmp_path / "runs"}
    ranks = [dict(common, mode="ranks", rank=r, world=2, coordinator=f"127.0.0.1:{port}",
                  out=tmp_path / f"rank{r}.npz") for r in range(2)]
    single = dict(common, mode="single", world=2, out=tmp_path / "single.npz")
    r0, r1, one = _run_workers(ranks + [single])
    assert [str(r0[f"ranks/det_route{i}"]) for i in range(4)] == ["fused"] * 2 + ["loop"] * 2
    names = [k[len("ranks/"):] for k in r0 if k.startswith("ranks/")]
    assert len([n for n in names if n.startswith("fit_param/")]) == len(param_shapes(tcfg))
    for n in names:
        np.testing.assert_array_equal(r0[f"ranks/{n}"], r1[f"ranks/{n}"], err_msg=n)
        np.testing.assert_array_equal(r0[f"ranks/{n}"], one[f"ordered/{n}"], err_msg=n)
    wrapped = [k for k in r0 if k.startswith("wrap/")]
    assert len(wrapped) == 2 * (1 + 2 + 2 * len(param_shapes(tcfg))) + 2
    for k in wrapped:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        np.testing.assert_array_equal(r0[k], one[k], err_msg=k)
    assert np.isfinite(r0["ranks/fit_loss"]).all()


def test_torch_bf16_scann_train_end_to_end(tmp_path):
    """``Scann.prepare_dataset -> train -> evaluate -> load_model_infer`` at
    model.dtype bfloat16 on the CPU on a synthetic dataset: every bucket's
    step takes the route its gate gives (here "fused"), the loss is finite
    and falls over 3 epochs, the trained params stay f32, and the loaded run
    predicts what the trainer does."""
    from scann_tpu_torch.data.synthetic import make_synthetic_dataset

    energy, nbr = make_synthetic_dataset(str(tmp_path / "data"), n_structures=60, max_atoms=12)
    cfg = ScannConfig(model=ModelConfig(**SMALL, dtype="bfloat16"),
                      hyper=HyperConfig(batch_size=16, epochs=3, lr=2e-3, seed=0,
                                        data_energy_path=energy, data_nei_path=nbr,
                                        save_path=str(tmp_path / "run")),
                      tpu=TpuConfig(max_buckets=2))
    scann = Scann(cfg, device="cpu")
    scann.prepare_dataset()
    routes = {scann.trainer.train_route(*b.shape) for b in scann.train_buckets}
    assert routes == {"fused"}
    hist = scann.train()
    assert np.isfinite(hist["loss"]).all() and hist["loss"][-1] < hist["loss"][0], hist["loss"]
    assert all(v.dtype == torch.float32 for v in scann.trainer.params.values())
    result = scann.evaluate()
    assert np.isfinite(result["test_mae"])
    mine = scann.predict_data(scann.test_buckets)
    loaded = Scann.load_model_infer(scann.trainer.workdir, device="cpu")
    assert loaded.config.model.dtype == "bfloat16"
    np.testing.assert_allclose(loaded.predict_data(scann.test_buckets), mine, rtol=1e-6)


# --- the dropout masks of the bf16 training forward --------------------------------------

@pytest.mark.parametrize("exact_pools", [True, False])
def test_torch_bf16_dropout_masks_follow_the_kernels(exact_pools):
    """``reference_bf16_forward`` at rate 0.1 takes the masks
    ``dropout_masks_for`` gives the kernels (the plain versions of #1 and #3
    at that rate equal it handed those masks, bit for bit) and applies them
    where the f32 model does: on the embedding, the attention (``use_drop``)
    and each ResidualNorm's FFN output. Held to the f32 eager model on the
    same masks within JAX's bf16 bound, which the bf16 forward without
    masks misses."""
    tcfg = ModelConfig(**SMALL, g_update=True, use_drop=True, dtype="bfloat16")
    f32 = dataclasses.replace(tcfg, dtype="float32")
    x = _torch(make_synthetic_batch(np.random.default_rng(10), B=3, M=12, N=6))
    params = {k: v for k, v in params_from_jax(jax.device_get(jit_init_vars(
        JaxScannModel(config=JaxModelConfig(**SMALL, g_update=True, use_drop=True)),
        jax.random.PRNGKey(10), {k: v.numpy() for k, v in x.items()})), tcfg).items()}
    masks = kfwd.dropout_masks_for(tcfg, x, 0.1, 42)
    assert masks is not None and masks.attn is not None
    plain = kfwd.fused_scann_forward if exact_pools else kloop.loop_scann_forward
    with torch.no_grad():
        got = plain(params, x, tcfg, False, 0.1, 42)
        want = kfwd.reference_bf16_forward(params, x, tcfg, False, exact_pools, masks)
        eager = scann_forward(params, x, f32, False, masks)
        unmasked = kfwd.reference_bf16_forward(params, x, tcfg, False, exact_pools)
    for g, w, e in zip(got, want, eager):
        assert torch.equal(g, w)
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=RTOL, atol=ATOL)
    # the masks move the property further than bf16 rounding does
    near = lambda a: np.abs(a.numpy() - eager[0].numpy()).mean()
    print(f"mean |bf16 - f32 eager| on the same masks {near(got[0]):.3e}, without them "
          f"{near(unmasked[0]):.3e}")
    assert near(unmasked[0]) > 4 * near(got[0])


def test_torch_bf16_eager_dropout_keeps_the_dtype():
    """The per-layer route's eager bf16 model applies its dropout masks as
    flax's ``nn.Dropout`` does, in the masked tensor's own dtype: with
    masks of ones (embedding, FFN and attention) it computes exactly what it
    computes without masks, where an f32 mask promoting a bfloat16 tensor to
    f32 would carry f32 activations into the next layer."""
    from scann_tpu_torch.ops.dropout import DropoutMasks

    tcfg = ModelConfig(**SMALL, g_update=True, use_drop=True, dtype="bfloat16")
    x = _torch(make_synthetic_batch(np.random.default_rng(11), B=3, M=12, N=6))
    params = {k: v for k, v in params_from_jax(jax.device_get(jit_init_vars(
        JaxScannModel(config=JaxModelConfig(**SMALL, g_update=True, use_drop=True)),
        jax.random.PRNGKey(11), {k: v.numpy() for k, v in x.items()})), tcfg).items()}
    L, D, H = tcfg.n_attention, tcfg.local_dim, tcfg.num_head
    ones = DropoutMasks(torch.ones(3, 12, D), [torch.ones(3, 12, D)] * L,
                        [torch.ones(3, 12, 6, H)] * L)
    with torch.no_grad():
        want = scann_forward(params, x, tcfg)
        got = scann_forward(params, x, tcfg, False, ones)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
