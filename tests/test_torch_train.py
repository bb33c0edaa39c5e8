"""The PyTorch port's training path on the CPU: schedules and a 20-step
loss trajectory against the JAX package, a crystal trajectory by the loop
route and by the per-layer route against the JAX loop-kernel step, exact
resume, the parameter version that keeps the kernels' weight layout fresh,
yaml-free configs and checkpoints, and the two training CLIs."""


import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from conftest import jit_init_vars, make_synthetic_batch
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.kernels.scann_loop import loop_scann_train_grads as jax_loop_train_grads
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu.models.scann import l2_penalty as jax_l2_penalty
from scann_tpu.train import schedules as jax_schedules
from scann_tpu_torch.api import Scann
from scann_tpu_torch.compat import params_from_jax
from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig, TpuConfig, save_config
from scann_tpu_torch.data.pipeline import load_dataset, pack_dataset
from scann_tpu_torch.data.synthetic import make_synthetic_dataset
from scann_tpu_torch.models.scann import ScannModel, l2_penalty
from scann_tpu_torch.train import loop, schedules

torch.set_num_threads(1)

SMALL = dict(n_atoms=10, embedding_dim=16, n_attention=2, local_dim=32,
             num_head=4, global_dim=32, dense_out=16)


def test_torch_schedules_match_jax():
    cos, jcos = (m.make_cosine_lr(5e-4, 1e-4, 7, 3, 1e-5) for m in (schedules, jax_schedules))
    for step in (0, 1, 5, 10, 11, 40):
        assert cos(step) == pytest.approx(float(jcos(step)), rel=1e-6)
    s, js = schedules.SGDRSchedule(5e-4, 1e-4, t0=3), jax_schedules.SGDRSchedule(5e-4, 1e-4, t0=3)
    for val in (400.0, 2.0, 1.5, 1.7, 1.2, 1.1, 1.3, 0.9, 0.95, 0.8):
        assert s.epoch_begin() == pytest.approx(js.epoch_begin(), rel=1e-12)
        s.epoch_end(val)
        js.epoch_end(val)
    assert s.state_dict() == js.state_dict()
    t = schedules.SGDRSchedule(5e-4, 1e-4, t0=3)
    t.load_state_dict(s.state_dict())
    assert t.epoch_begin() == s.epoch_begin()


def test_torch_l2_penalty_matches_jax(rng):
    jcfg, tcfg = JaxModelConfig(**SMALL), ModelConfig(**SMALL)
    inputs = make_synthetic_batch(rng, B=2, M=8, N=4)
    jparams = jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(0), inputs)
    tparams = params_from_jax(jax.device_get(jparams), tcfg)
    assert float(l2_penalty(tparams)) == pytest.approx(
        float(jax_l2_penalty(jparams["params"])), rel=1e-6)


def test_torch_training_trajectory_matches_jax_step(rng):
    """20 Adam steps at dropout 0: the port's Trainer step (the backward
    kernel's plain version, the 1/(n*rmse) scale, the l2 gradient, Adam
    eps=1e-7, lr = sgdr_lr / (1 + decay*step)) against a JAX loop written
    from model.apply + RMSE + l2_penalty + optax.scale_by_adam."""
    jcfg, tcfg = JaxModelConfig(**SMALL), ModelConfig(**SMALL)
    data = make_synthetic_batch(rng, B=12, M=12, N=6)
    y_all = np.linspace(-1.5, 1.5, 12).astype(np.float32)
    model = JaxScannModel(config=jcfg)
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

    cfg = ScannConfig(model=tcfg, hyper=HyperConfig(batch_size=4))
    trainer = loop.Trainer(cfg, "cpu")
    trainer.load_params(params_from_jax(jax.device_get(jparams), tcfg))
    trainer.dropout_rate = 0.0
    opt = tx.init(jparams)
    plan = np.random.default_rng(1)
    got, want = [], []
    for step in range(20):
        idx = plan.choice(12, size=4, replace=False)
        lr = 5e-4 / (1.0 + 1e-5 * step)
        batch = {k: v[idx] for k, v in data.items()}
        jparams, opt, jloss = jax_step(jparams, opt, batch, jnp.asarray(y_all[idx]), lr)
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        loss, _ = trainer.train_step(tb, torch.from_numpy(y_all[idx]), lr, seed=0)
        got.append(float(loss))
        want.append(float(jloss))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    # Adam hides the scale of the gradient from the loss: the weights and the
    # moments after 20 steps must agree too, each tensor within 1e-4 x its max
    assert opt.count == trainer.step == 20
    for mine, ref in ((trainer.params, jparams), (trainer.mu, opt.mu), (trainer.nu, opt.nu)):
        ref = params_from_jax(jax.device_get(ref), tcfg)
        for k, r in ref.items():
            torch.testing.assert_close(mine[k], r, rtol=0,
                                       atol=1e-4 * float(r.abs().max()), msg=k)


CRYSTAL_STEPS, CRYSTAL_BATCH = 6, 4
CRYSTAL = dict(SMALL, n_atoms=30)       # the synthetic crystals go up to Fe (26)


@pytest.fixture(scope="module")
def crystal_trajectory(tmp_path_factory):
    """Synthetic periodic crystals of 66-72 sites packed into one (72, N)
    bucket, and CRYSTAL_STEPS Adam steps on them at dropout 0 by the JAX
    package: its loop backward kernel in interpret mode (one-shot mode), the
    1/(n*rmse) scale, the l2 gradient and optax.scale_by_adam. Returns (the
    bucket, the initial flax params, the batches' rows, the losses, the final
    params)."""
    jcfg = JaxModelConfig(**CRYSTAL)
    data_dir = str(tmp_path_factory.mktemp("torch_crystal_trajectory"))
    energy, nbr = make_synthetic_dataset(data_dir, n_structures=10, min_atoms=66, max_atoms=72,
                                         periodic=True, seed=3)
    records, neighbors = load_dataset(energy, nbr, "homo")
    bucket, = pack_dataset(records, neighbors, g_update=True, max_buckets=1)
    assert bucket.shape[0] == 72
    data = bucket.inputs
    y_all = np.linspace(-1.5, 1.5, bucket.num_structures).astype(np.float32)
    model = JaxScannModel(config=jcfg)
    first = {k: v[:CRYSTAL_BATCH] for k, v in data.items()}
    params0 = jax.device_get(jit_init_vars(model, jax.random.PRNGKey(0), first)["params"])
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-7)

    @jax.jit
    def jax_step(params, opt, batch, y, lr):
        pred, raw = jax_loop_train_grads(params, batch, y, jcfg, interpret=True)
        rmse = jnp.sqrt(jnp.mean((pred[:, 0] - y) ** 2))
        l2g = jax.grad(lambda p: jax_l2_penalty(p, 1e-4))(params)
        g = jax.tree.map(lambda r, g2: r / (y.shape[0] * rmse) + g2, raw, l2g)
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, jax.tree.map(lambda u: -lr * u, upd))
        return params, opt, rmse + jax_l2_penalty(params, 1e-4)

    plan = np.random.default_rng(1)
    rows = [plan.choice(bucket.num_structures, size=CRYSTAL_BATCH, replace=False)
            for _ in range(CRYSTAL_STEPS)]
    params, opt, losses = params0, tx.init(params0), []
    for step, idx in enumerate(rows):
        before = params
        params, opt, _ = jax_step(params, opt, {k: v[idx] for k, v in data.items()},
                                  jnp.asarray(y_all[idx]), 5e-4 / (1.0 + 1e-5 * step))
        pred = model.apply({"params": before}, {k: v[idx] for k, v in data.items()},
                           deterministic=True)["property"][:, 0]
        losses.append(float(jnp.sqrt(jnp.mean((pred - y_all[idx]) ** 2))
                            + jax_l2_penalty(before, 1e-4)))
    return bucket, params0, rows, y_all, losses, jax.device_get(params)


@pytest.mark.parametrize("route", ["loop", "per_layer"])
def test_torch_crystal_trajectory_matches_jax_loop_step(route, crystal_trajectory, monkeypatch):
    """A bucket with M = 72 > 64 trains by the loop route on the CPU (the loop
    backward's plain version); with the whole-model gates shut it trains by
    the per-layer route. Either way the losses and the weights after the
    steps match the JAX loop-kernel step: losses to 1e-4 relative, every
    tensor within 1e-4 x its max."""
    tcfg = ModelConfig(**CRYSTAL)
    bucket, params0, rows, y_all, want, final = crystal_trajectory
    trainer = loop.Trainer(ScannConfig(model=tcfg, hyper=HyperConfig(batch_size=CRYSTAL_BATCH)),
                           "cpu")
    trainer.load_params(params_from_jax(params0, tcfg))
    trainer.dropout_rate = 0.0
    if route == "per_layer":
        monkeypatch.setattr(loop.kloop, "backward_refusal", lambda *a, **k: "shut for this test")
    assert trainer.train_route(*bucket.shape) == route
    got = []
    for step, idx in enumerate(rows):
        tb = loop._to_device({k: v[idx] for k, v in bucket.inputs.items()}, trainer.device)
        loss, _ = trainer.train_step(tb, torch.from_numpy(y_all[idx]),
                                     5e-4 / (1.0 + 1e-5 * step), seed=0)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert trainer.step == CRYSTAL_STEPS
    for k, r in params_from_jax(final, tcfg).items():
        torch.testing.assert_close(trainer.params[k], r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()), msg=k)


def _config(tmp_path, n=40, **hyper):
    energy, nbr = make_synthetic_dataset(str(tmp_path / "data"), n_structures=n, min_atoms=3,
                                         max_atoms=10, seed=2)
    h = dict(batch_size=8, scheduler="sgdr", data_energy_path=energy, data_nei_path=nbr,
             save_path=str(tmp_path / "run"), epochs=2, seed=0)
    h.update(hyper)
    return ScannConfig(model=ModelConfig(**SMALL), hyper=HyperConfig(**h),
                       tpu=TpuConfig(max_buckets=2))


def test_torch_resume_is_exact(tmp_path):
    """2 epochs equal 1 epoch + resume + 1 epoch, bit for bit, in params and
    Adam state (dropout on: the epoch order and the dropout seeds come from
    (seed, epoch, bucket) alone)."""
    whole = Scann(_config(tmp_path / "a"), device="cpu")
    whole.prepare_dataset()
    whole.train(epochs=2)
    first = Scann(_config(tmp_path / "b"), device="cpu")
    first.prepare_dataset()
    first.train(epochs=1)
    resumed = Scann(_config(tmp_path / "b"), device="cpu")
    resumed.prepare_dataset()
    resumed.train(epochs=2, resume=True)
    a, b = whole.trainer, resumed.trainer
    assert a.step == b.step > 0
    for d1, d2 in ((a.params, b.params), (a.mu, b.mu), (a.nu, b.nu)):
        assert set(d1) == set(d2)
        assert all(torch.equal(d1[k], d2[k]) for k in d1)
    lines = [json.loads(x) for x in open(os.path.join(b.workdir, "metrics.jsonl"))]
    assert [r["epoch"] for r in lines] == [0, 1]


def test_torch_kernel_weights_follow_the_parameter_version(monkeypatch):
    """The kernels' layout of the weights is rebuilt after every change of
    the parameters (an optimizer step updates them in place), and never in
    between; evaluation after a step matches the eager model on the new
    weights."""
    calls = []
    real = loop.pack_params
    monkeypatch.setattr(loop, "pack_params", lambda p, c: calls.append(1) or real(p, c))
    cfm = ModelConfig(**SMALL)
    s = Scann(ScannConfig(model=cfm, hyper=HyperConfig(batch_size=3)), device="cpu")
    s.init_params(0)
    s.trainer.kernel_params()
    s.trainer.kernel_params()
    assert len(calls) == 1
    x = make_synthetic_batch(np.random.default_rng(0), B=3, M=12, N=6)
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    v0 = s.trainer.version
    s.trainer.train_step(tx, torch.tensor([0.1, -0.2, 0.3]), 1e-2, seed=1)
    assert s.trainer.version == v0 + 1
    packed = s.trainer.kernel_params()
    assert len(calls) == 2
    assert torch.equal(packed["wk"][1], s.params["local_attention_1/key/kernel"])
    pred, ga = s.forward_eval(s.params, x)
    with torch.no_grad():
        want = ScannModel(cfm, params={k: v.clone() for k, v in s.params.items()})(tx)
    torch.testing.assert_close(pred, want["property"], rtol=1e-6, atol=1e-7)
    s.load_params(_nested(s.params))
    assert s.trainer.version == v0 + 2
    s.trainer.kernel_params()
    assert len(calls) == 3


def _nested(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy()
    return tree


def test_torch_config_and_checkpoints_need_no_yaml(tmp_path, monkeypatch):
    """save_config writes the mapping by hand (yaml.safe_load reads back
    to_dict()), and a trained run loads for inference from its checkpoint
    alone while yaml cannot be imported."""
    cfg = _config(tmp_path, n=24, epochs=1)
    cfg.tpu.observed_buckets = [[16, 8], [32, 16]]
    cfg.hyper.target_mean = -0.2431
    path = tmp_path / "c.yaml"
    save_config(cfg, str(path))
    assert yaml.safe_load(open(path)) == cfg.to_dict()
    monkeypatch.setitem(sys.modules, "yaml", None)
    s = Scann(cfg, device="cpu")
    s.prepare_dataset()
    s.train()
    s.evaluate()
    run = s.trainer.workdir
    assert sorted(os.listdir(run)) == ["checkpoints", "config.yaml", "hist_data.json",
                                       "metrics.jsonl", "report.txt"]
    ckpt = torch.load(os.path.join(run, "checkpoints", "best.pt"), weights_only=True)
    assert ckpt["config"] == s.config.to_dict()
    loaded = Scann.load_model_infer(run, device="cpu")
    np.testing.assert_array_equal(loaded.predict_data(s.test_buckets),
                                  s.predict_data(s.test_buckets))


def test_torch_train_and_predict_model_clis(tmp_path, capsys):
    from scann_tpu_torch.cli import predict_model, train

    cfg = _config(tmp_path, n=24, epochs=1)
    path = tmp_path / "c.yaml"
    save_config(cfg, str(path))
    train.main(["homo", str(path), "--epochs", "1", "--device", "cpu"])
    run = f"{cfg.hyper.save_path}_homo"
    assert "Test MAE" in open(os.path.join(run, "report.txt")).read()
    predict_model.main([run, "--device", "cpu"])
    import pickle

    out = pickle.load(open(os.path.join(run, "energy_pre_homo.pickle"), "rb"))
    assert out["prediction"].shape == out["target"].shape == (24,)
    with pytest.raises(SystemExit):
        train.main(["homo", str(path), "--structure-packing", "--device", "cpu"])
    assert "not ported" in capsys.readouterr().err
