"""The PyTorch port's H5 export, optimizer migration and checkpoint loading
against the JAX package, on the CPU: ``Scann.export_h5`` against the JAX
``save_h5_weights`` on the weights of every golden fixture, the round trip
through ``load_h5_params``, ``params_to_flax`` as the inverse of
``params_from_jax``, ``load_h5_optimizer`` on the published full-model H5
in both Adam slot layouts and its refusals, three Adam steps after
``load_pretrained(h5, with_optimizer=True)`` against a JAX loop from the
same state, ``load_pretrained`` of the port's run directories and
checkpoints, and the export CLI."""

import json
import os
import re
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import make_synthetic_batch
from scann_tpu.compat import load_h5_optimizer as jax_load_h5_optimizer
from scann_tpu.compat import load_h5_params as jax_load_h5_params
from scann_tpu.compat import save_h5_weights as jax_save_h5_weights
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu.models.scann import l2_penalty as jax_l2_penalty
from scann_tpu_torch.api import Scann
from scann_tpu_torch.cli.export import main as export_main
from scann_tpu_torch.compat import (
    load_h5_optimizer,
    load_h5_params,
    params_from_jax,
    params_to_flax,
)
from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig
from scann_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
CASES = sorted(f[:-5] for f in os.listdir(FIXDIR) if f.endswith(".json"))
QM9FULL = os.path.join(FIXDIR, "scann_plus_qm9full.h5")


def case(name):
    """(port config, JAX config, the fixture's H5 path)."""
    with open(os.path.join(FIXDIR, f"{name}.json")) as f:
        model = json.load(f)["model"]
    h5 = os.path.join(FIXDIR, f"{name}.h5")
    if not os.path.exists(h5):
        h5 = os.path.join(FIXDIR, f"{name}.weights.h5")
    pick = lambda cls: cls(**{k: v for k, v in model.items() if k in cls.__dataclass_fields__})
    return pick(ModelConfig), pick(JaxModelConfig), h5


def h5_datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, np.asarray(o))
                     if isinstance(o, h5py.Dataset) else None)
    return out


def test_torch_golden_cases_are_all_fixtures():
    assert CASES == ["scann_base", "scann_cgcnn", "scann_plus", "scann_plus_mp2018full",
                     "scann_plus_ptgp11", "scann_plus_qm9full", "scann_ring_eb"]


@pytest.mark.parametrize("name", CASES)
def test_torch_export_h5_matches_jax(name, tmp_path):
    """The same weights written by ``Scann.export_h5`` and by the JAX
    ``save_h5_weights``: the same dataset paths (Keras names, counters and
    all), arrays equal; the port reads its file back to the same tensors,
    and ``params_to_flax`` undoes ``params_from_jax`` exactly."""
    cfm, jcfm, h5 = case(name)
    scann = Scann(ScannConfig(model=cfm), device="cpu")
    params = scann.load_params(load_h5_params(h5, cfm))
    mine, ref = str(tmp_path / "torch.h5"), str(tmp_path / "jax.h5")
    assert scann.export_h5(mine) == mine
    jax_save_h5_weights(jax_load_h5_params(h5, jcfm), jcfm, ref)
    got, want = h5_datasets(mine), h5_datasets(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    back = params_from_jax(load_h5_params(mine, cfm), cfm)
    assert all(torch.equal(back[k], params[k]) for k in params)
    again = params_from_jax(params_to_flax(params, cfm), cfm)
    assert list(again) == list(params) and all(torch.equal(again[k], params[k]) for k in params)


def test_torch_params_to_flax_checks_the_config():
    cfm, _, h5 = case("scann_plus")
    params = params_from_jax(load_h5_params(h5, cfm), cfm)
    with pytest.raises(ValueError, match="keys"):
        params_to_flax({k: v for k, v in params.items() if k != "after_Lc/bias"}, cfm)
    params["after_Lc/bias"] = params["after_Lc/bias"][:-1]
    with pytest.raises(ValueError, match="after_Lc/bias: shape"):
        params_to_flax(params, cfm)


def tf_keras_layout(src, dst):
    """A copy of ``src`` whose Adam slots are renamed from the publisher's
    ``Adam/m/<var>`` to tf_keras' ``Adam/<var>/m``."""
    data = h5_datasets(src)
    with h5py.File(dst, "w") as f:
        for name, arr in data.items():
            m = re.fullmatch(r"optimizer_weights/Adam/([mv])/(.+):0", name)
            f.create_dataset(f"optimizer_weights/Adam/{m[2]}/{m[1]}:0" if m else name, data=arr)
    assert "optimizer_weights/Adam/dense_embed/kernel/m:0" in h5_datasets(dst)


@pytest.mark.parametrize("layout", ["publisher", "tf_keras"])
def test_torch_load_h5_optimizer_matches_jax(layout, tmp_path):
    cfm, jcfm, h5 = case("scann_plus_qm9full")
    if layout == "tf_keras":
        tf_keras_layout(h5, str(tmp_path / "tf_keras.h5"))
        h5 = str(tmp_path / "tf_keras.h5")
    count, mu, nu = load_h5_optimizer(h5, cfm)
    jcount, jmu, jnu = jax_load_h5_optimizer(h5, jcfm)
    assert count == jcount == 120
    scann = Scann(ScannConfig(model=cfm), device="cpu")
    scann.load_pretrained(h5, with_optimizer=True)
    assert scann.trainer.step == 120
    for got, ref, installed in ((mu, jmu, scann.trainer.mu), (nu, jnu, scann.trainer.nu)):
        got, ref = params_from_jax(got, cfm), params_from_jax(ref, cfm)
        assert set(got) == set(ref) == set(installed)
        for k in ref:
            assert torch.equal(got[k], ref[k]) and torch.equal(installed[k], ref[k]), k


def _write(path, datasets):
    with h5py.File(path, "w") as f:
        for name, arr in datasets.items():
            f.create_dataset(name, data=arr)
    return str(path)


@pytest.mark.parametrize("what", ["weights-only", "no-counter", "no-slots", "anonymous-dense"])
def test_torch_load_h5_optimizer_refusals_match_jax(what, tmp_path):
    cfm, jcfm, _ = case("scann_plus")
    k = np.zeros((2, 2), np.float32)
    h5 = {"weights-only": os.path.join(FIXDIR, "scann_plus.h5"),
          "no-counter": _write(tmp_path / "a.h5", {
              f"optimizer_weights/Adam/{s}/after_Lc/kernel:0": k for s in "mv"}),
          "no-slots": _write(tmp_path / "b.h5", {"optimizer_weights/iteration:0": np.int64(3)}),
          "anonymous-dense": _write(tmp_path / "c.h5", {
              "optimizer_weights/iteration:0": np.int64(3),
              **{f"optimizer_weights/Adam/{s}/{d}/kernel:0": k
                 for s in "mv" for d in ("dense", "dense_1", "dense_2", "residual_norm/x")}}),
          }[what]
    errors = []
    for fn, c in ((load_h5_optimizer, cfm), (jax_load_h5_optimizer, jcfm)):
        with pytest.raises(ValueError) as err:
            fn(h5, c)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert re.search({"weights-only": "no optimizer_weights group",
                      "no-counter": "no iteration counter",
                      "no-slots": "no m/v slot variables",
                      "anonymous-dense": "cannot place 3 anonymous Dense"}[what], errors[0])
    if what == "weights-only":
        scann = Scann(ScannConfig(model=cfm), device="cpu")
        with pytest.raises(ValueError, match="weights-only"):
            scann.load_pretrained(h5, with_optimizer=True)


def test_torch_load_optimizer_refuses_a_mismatch():
    cfm, _, h5 = case("scann_plus")
    trainer = Trainer(ScannConfig(model=cfm), "cpu")
    tree = load_h5_params(h5, cfm)["params"]
    with pytest.raises(RuntimeError, match="load params"):
        trainer.load_optimizer(3, tree, tree)
    trainer.load_params(params_from_jax(tree, cfm))
    short = dict(tree)
    del short["after_Lc"]
    with pytest.raises(ValueError, match="missing"):
        trainer.load_optimizer(3, tree, short)
    trainer.load_optimizer(3, tree, tree)
    assert trainer.step == 3


def test_torch_migrated_steps_match_jax(rng):
    """Three Adam steps at dropout 0 after ``load_pretrained(h5,
    with_optimizer=True)`` against a JAX loop (model.apply + RMSE +
    l2_penalty + optax.scale_by_adam) started from the same weights and the
    same (count, mu, nu): t goes on from count + 1 and the lr decays by the
    step, as the reference's Adam does after count steps."""
    cfm, jcfm, h5 = case("scann_plus_qm9full")
    data = make_synthetic_batch(rng, B=8, M=8, N=4, n_atoms=10)
    y_all = np.linspace(-1.0, 1.0, 8).astype(np.float32)
    model = JaxScannModel(config=jcfm)
    jparams = jax.tree.map(jnp.asarray, jax_load_h5_params(h5, jcfm)["params"])
    count, mu, nu = jax_load_h5_optimizer(h5, jcfm)
    opt = optax.ScaleByAdamState(count=jnp.asarray(count, jnp.int32),
                                 mu=jax.tree.map(jnp.asarray, mu),
                                 nu=jax.tree.map(jnp.asarray, nu))
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-7)

    @jax.jit
    def jax_step(params, opt, batch, y, lr):
        def loss_fn(p):
            pred = model.apply({"params": p}, batch, deterministic=True)["property"][:, 0]
            return jnp.sqrt(jnp.mean((pred - y) ** 2)) + jax_l2_penalty(p, 1e-4)

        loss, g = jax.value_and_grad(loss_fn)(params)
        upd, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, jax.tree.map(lambda u: -lr * u, upd)), opt, loss

    hyper = HyperConfig(batch_size=4)
    scann = Scann(ScannConfig(model=cfm, hyper=hyper), pretrained=QM9FULL, device="cpu")
    assert scann.trainer.step == 0                 # pretrained= loads the weights alone
    scann.load_pretrained(QM9FULL, with_optimizer=True)
    trainer = scann.trainer
    trainer.dropout_rate = 0.0
    got, want = [], []
    plan = np.random.default_rng(1)            # batches drawn as test_torch_train draws them
    for _ in range(3):
        idx = plan.choice(8, size=4, replace=False)
        lr = hyper.lr / (1.0 + hyper.adam_decay * trainer.step)
        batch = {n: v[idx] for n, v in data.items()}
        jparams, opt, jloss = jax_step(jparams, opt, batch, jnp.asarray(y_all[idx]), lr)
        loss, _ = trainer.train_step({n: torch.from_numpy(v) for n, v in batch.items()},
                                     torch.from_numpy(y_all[idx]), lr, seed=0)
        got.append(float(loss))
        want.append(float(jloss))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(opt.count) == trainer.step == count + 3
    for mine, ref in ((trainer.params, jparams), (trainer.mu, opt.mu), (trainer.nu, opt.nu)):
        ref = params_from_jax(jax.device_get(ref), cfm)
        for k, r in ref.items():
            torch.testing.assert_close(mine[k], r, rtol=0,
                                       atol=1e-4 * float(r.abs().max()), msg=k)


SMALL = dict(n_atoms=10, embedding_dim=16, n_attention=2, local_dim=32,
             num_head=4, global_dim=32, dense_out=16)


def _state(trainer):
    return dict(params=trainer.params, mu=trainer.mu, nu=trainer.nu, step=trainer.step)


def _same_state(a, b):
    assert a["step"] == b["step"]
    for part in ("params", "mu", "nu"):
        assert list(a[part]) == list(b[part])
        assert all(torch.equal(a[part][k], b[part][k].cpu()) for k in a[part]), part


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A run directory of the port on the CPU: checkpoints/last.pt after
    two Adam steps, best.pt after three. Returns (config, run dir, a batch,
    its targets, the states saved as last and best)."""
    run = str(tmp_path_factory.mktemp("torch_port_run") / "run")
    cfg = ScannConfig(model=ModelConfig(**SMALL), hyper=HyperConfig(batch_size=4))
    data = make_synthetic_batch(np.random.default_rng(3), B=4, M=8, N=4)
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    y = torch.linspace(-1.0, 1.0, 4)
    trainer = Trainer(cfg, "cpu", run)
    trainer.init_state(0)
    states = {}
    for name, steps in (("last", 2), ("best", 1)):
        for _ in range(steps):
            trainer.train_step(batch, y, 5e-4, seed=7)
        trainer.save_checkpoint(name, meta={"epoch": trainer.step})
        states[name] = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
                        for k, v in _state(trainer).items()}
    return cfg, run, batch, y, states


@pytest.mark.parametrize("where", ["run", "checkpoints/last", "checkpoints/last.pt",
                                   "checkpoints/best.pt"])
def test_torch_load_pretrained_restores_a_port_checkpoint(where, port_run):
    """A run directory restores its best, checkpoints/<name>[.pt] that name:
    parameters, Adam state and step bit for bit; the next step of the loaded
    trainer equals the next step of the trainer in the saved state."""
    cfg, run, batch, y, states = port_run
    path = run if where == "run" else os.path.join(run, where)
    name = "best" if where in ("run", "checkpoints/best.pt") else "last"
    loaded = Scann(ScannConfig.from_dict(cfg.to_dict()), pretrained=path, device="cpu")
    assert loaded.trainer.workdir == run
    _same_state(_state(loaded.trainer), states[name])
    original = Trainer(cfg, "cpu", run)
    original.restore_checkpoint(name)
    for t in (original, loaded.trainer):
        t.train_step(batch, y, 5e-4, seed=11)
    _same_state(_state(loaded.trainer), _state(original))


def test_torch_load_pretrained_refuses_other_directories(port_run, tmp_path):
    """An orbax checkpoint directory of the JAX package, a checkpoint name
    that is not there and a directory without checkpoints are refused with
    what the port reads and how to cross over."""
    cfg, run, _, _, _ = port_run
    orbax = tmp_path / "jax_run" / "checkpoints" / "best"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    scann = Scann(cfg, device="cpu")
    for path in (str(orbax), str(orbax.parent.parent), os.path.join(run, "checkpoints", "mid"),
                 str(tmp_path)):
        with pytest.raises(ValueError, match="orbax checkpoint directory of the JAX package "
                                             "cannot be read here: restore it with scann_tpu"):
            scann.load_pretrained(path)
    assert scann.params is None


def test_torch_load_params_refuses_other_shapes(port_run):
    cfg, run, _, _, _ = port_run
    wide = ScannConfig(model=ModelConfig(**dict(SMALL, local_dim=64, global_dim=64)))
    with pytest.raises(ValueError, match="shapes do not match"):
        Scann(wide, pretrained=run, device="cpu")


def test_torch_export_cli(port_run, tmp_path):
    """``cli.export`` writes the run's best weights, which the port's and
    the JAX package's H5 loaders read back exactly."""
    cfg, run, _, _, states = port_run
    out = str(tmp_path / "exported.h5")
    assert export_main([run, out, "--device", "cpu"]) == 0
    back = params_from_jax(load_h5_params(out, cfg.model), cfg.model)
    jcfm = JaxModelConfig(**SMALL)
    jback = params_from_jax(jax_load_h5_params(out, jcfm), cfg.model)
    for k, v in states["best"]["params"].items():
        assert torch.equal(back[k], v) and torch.equal(jback[k], v), k


def test_torch_export_cli_names_h5py(port_run, tmp_path, monkeypatch, capsys):
    _, run, _, _, _ = port_run
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(SystemExit):
        export_main([run, str(tmp_path / "none.h5"), "--device", "cpu"])
    assert "h5py" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "none.h5")

