"""Data parallelism of the PyTorch port over ``torch.distributed``
(``scann_tpu_torch/parallel/``, ``kernels/sharded.py``, the Trainer's
mesh), on the CPU with gloo.

The in-process tests are the counterparts of ``tests/test_distributed.py``'s
helpers: argument resolution, the no-op without a job, idempotence, the
single-process helpers, ``put_replicated`` / ``fetch``, the digest that
catches diverging replicas, ``hierarchical_order``, the rank layout.

``test_torch_two_gloo_ranks_train_as_ordered_shards`` spawns two ranks
(``tests/torch_distributed_worker.py``) on a tiny model (2 layers, D=32, 4
heads, batch 16) with a molecule bucket on the "fused" route and a crystal
bucket on the "loop" route. Their steps, weights, eval batches, a
one-epoch ``fit`` at dropout 0.1 and the outputs and gradients of the five
``make_sharded_*`` wrappers must equal, bit for bit, one process that runs
the same shards in rank order; match the whole-batch run within 1e-4
(relative on losses, of each tensor's max on weights); and, at dropout 0,
match the JAX package's single-device step on the same global batches at
the tolerance of ``test_torch_train.py``.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from conftest import jit_init_vars, make_synthetic_batch
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu.models.scann import l2_penalty as jax_l2_penalty
from scann_tpu_torch import parallel
from scann_tpu_torch.compat import params_from_jax
from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.models.scann import param_shapes
from scann_tpu_torch.parallel import distributed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_distributed_worker.py")
JOB_ENV = ("SCANN_TPU_COORDINATOR", "SCANN_TPU_NUM_PROCESSES", "SCANN_TPU_PROCESS_ID",
           "SCANN_TPU_DISTRIBUTED", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
           "LOCAL_RANK")
TINY = dict(n_atoms=10, embedding_dim=8, n_attention=2, local_dim=32, num_head=4,
            global_dim=32, dense_out=16)


@pytest.fixture
def no_job(monkeypatch):
    for var in JOB_ENV:
        monkeypatch.delenv(var, raising=False)
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(dict(kw, backend=backend)))
    return calls


def test_torch_initialize_is_a_noop_without_a_job(no_job):
    assert distributed.initialize() is False
    assert no_job == []


def test_torch_initialize_resolves_arguments_as_the_jax_package(no_job, monkeypatch):
    monkeypatch.setenv("SCANN_TPU_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("SCANN_TPU_NUM_PROCESSES", "4")
    monkeypatch.setenv("SCANN_TPU_PROCESS_ID", "3")
    assert distributed.initialize(backend="gloo") is True
    # explicit arguments come before the environment
    assert distributed.initialize("10.0.0.2:99", 2, 1) is True
    monkeypatch.delenv("SCANN_TPU_COORDINATOR")
    monkeypatch.delenv("SCANN_TPU_NUM_PROCESSES")
    monkeypatch.delenv("SCANN_TPU_PROCESS_ID")
    # then torchrun's variables
    monkeypatch.setenv("MASTER_ADDR", "node0")
    monkeypatch.setenv("MASTER_PORT", "29400")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    assert distributed.initialize() is True
    want = lambda url, n, r: {"init_method": f"tcp://{url}", "world_size": n, "rank": r,
                              "backend": "gloo"}      # no card here: gloo by default
    assert no_job == [want("10.0.0.1:1234", 4, 3), want("10.0.0.2:99", 2, 1),
                      want("node0:29400", 8, 5)]
    # SCANN_TPU_DISTRIBUTED=1 alone asks for a job it cannot find
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var)
    monkeypatch.setenv("SCANN_TPU_DISTRIBUTED", "1")
    with pytest.raises(ValueError, match="coordinator address, number of processes, process id"):
        distributed.initialize()


def test_torch_initialize_is_idempotent(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)

    def refuse(*a, **k):
        raise AssertionError("initialized twice")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    assert distributed.initialize("127.0.0.1:1", 2, 0) is True


def test_torch_nccl_rank_drives_its_own_card(no_job, monkeypatch, tmp_path):
    """On NCCL a rank's work and collectives are on its own card,
    cuda:{LOCAL_RANK} (else its rank modulo the host's cards): initialize
    makes it the current device before it joins, and the collectives, the
    mesh, and a Trainer or Scann given a bare "cuda" take it."""
    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import ScannConfig
    from scann_tpu_torch.train.loop import Trainer

    order = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: order.append(("set_device", i)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: order.append(("join", backend, kw["rank"])))
    for var, v in (("MASTER_ADDR", "node0"), ("MASTER_PORT", "29400"), ("WORLD_SIZE", "8"),
                   ("RANK", "7"), ("LOCAL_RANK", "3")):
        monkeypatch.setenv(var, v)
    assert distributed.initialize() is True
    assert order == [("set_device", 3), ("join", "nccl", 7)]
    order.clear()
    monkeypatch.delenv("LOCAL_RANK")
    assert distributed.initialize("10.0.0.1:1", 16, 13) is True
    assert order == [("set_device", 5), ("join", "nccl", 13)]
    order.clear()
    assert distributed.initialize("10.0.0.1:1", 16, 13, backend="gloo") is True
    assert order == [("join", "gloo", 13)]         # gloo leaves the current device alone

    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 8)
    monkeypatch.setattr(dist, "get_rank", lambda: 7)
    monkeypatch.setattr(dist, "get_backend", lambda: "nccl")
    card = torch.device("cuda", 3)
    assert distributed.local_device() == card
    assert distributed._collective_device() == card
    assert parallel.make_mesh() == (8, 7, card)
    cfg = ScannConfig(model=ModelConfig(**TINY))
    assert Trainer(cfg, "cuda", str(tmp_path / "t")).device == card
    assert Scann(cfg, device="cuda", workdir=str(tmp_path / "s")).device == card
    assert Trainer(cfg, "cuda:1", str(tmp_path / "t")).device == torch.device("cuda", 1)
    assert Trainer(cfg, "cpu", str(tmp_path / "t")).device == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    assert distributed.local_device() == torch.device("cuda", 7)    # rank 7 of 8 cards
    monkeypatch.setattr(dist, "get_backend", lambda: "gloo")
    assert distributed._collective_device() == torch.device("cpu")


def test_torch_single_process_helpers():
    assert parallel.process_count() == 1 and parallel.process_index() == 0
    assert not parallel.is_multiprocess() and parallel.is_primary()
    mesh = parallel.make_mesh()
    assert (mesh.world, mesh.rank, mesh.device) == (1, 0, torch.device("cuda", 0))
    assert parallel.make_mesh(1) == mesh
    with pytest.raises(ValueError, match="need 2 processes"):
        parallel.make_mesh(2)
    t = torch.arange(3.0)
    assert distributed.gather_ordered(t)[0] is t


def test_torch_put_replicated_and_fetch_round_trip():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": [np.int32(3)],
            "c": torch.ones(2)}
    out = parallel.put_replicated(tree, "cpu", check=True)
    assert isinstance(out["a"], torch.Tensor) and out["a"].device.type == "cpu"
    assert isinstance(out["b"], list) and out["b"][0].dtype == torch.int32
    host = parallel.fetch(out)
    np.testing.assert_array_equal(host["a"], tree["a"])
    assert host["b"][0] == 3 and isinstance(host["c"], np.ndarray)


def test_torch_tree_digest_detects_divergence():
    a = {"x": np.arange(8, dtype=np.float32), "y": np.int32(2)}
    b = {"y": np.int32(2), "x": torch.arange(8, dtype=torch.float32)}
    assert distributed._tree_digest(a) == distributed._tree_digest(b)   # order, tensor or array
    b["x"] = b["x"].clone()
    b["x"][3] += 1e-6
    assert distributed._tree_digest(a) != distributed._tree_digest(b)
    c = {"x": np.arange(8, dtype=np.float32).reshape(2, 4), "y": np.int32(2)}
    assert distributed._tree_digest(a) != distributed._tree_digest(c)   # shape, same bytes
    d = {"z": np.arange(8, dtype=np.float32), "y": np.int32(2)}
    assert distributed._tree_digest(a) != distributed._tree_digest(d)   # another key


def test_torch_hierarchical_order_is_node_aware():
    class D:
        def __init__(self, index, local_rank, node_index=None):
            self.index = index
            self.local_rank = local_rank
            if node_index is not None:
                self.node_index = node_index

    # interleaved local ranks come back contiguous
    out = parallel.hierarchical_order([D(0, 0), D(1, 1), D(2, 0), D(3, 1)])
    assert [d.index for d in out] == [0, 2, 1, 3]
    # node-major still dominates
    out = parallel.hierarchical_order([D(0, 2, 1), D(1, 3, 1), D(2, 0, 0), D(3, 1, 0)])
    assert [d.index for d in out] == [2, 3, 0, 1]


def test_torch_batch_shard_splits_rows_in_rank_order():
    assert [parallel.batch_shard(r, 4, 16) for r in range(4)] == [
        slice(0, 4), slice(4, 8), slice(8, 12), slice(12, 16)]
    mesh = parallel.RankLayout(2, 1, torch.device("cpu"))
    assert parallel.batch_sharding(mesh, 16) == slice(8, 16)
    assert parallel.replicated_sharding(mesh) == torch.device("cpu")
    with pytest.raises(ValueError, match="multiple of the world size"):
        parallel.batch_shard(0, 3, 16)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(specs, timeout=120):
    """One subprocess per spec; each has its own timeout and must exit 0."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for var in JOB_ENV:
        env.pop(var, None)
    procs = []
    for spec in specs:
        cmd = [sys.executable, WORKER] + [a for k, v in spec.items() for a in (f"--{k}", str(v))]
        procs.append((spec, subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    outs = []
    try:
        for spec, p in procs:
            try:
                log, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                log, _ = p.communicate()
                raise AssertionError(f"worker {spec} timed out:\n{log[-4000:]}")
            assert p.returncode == 0, f"worker {spec} failed ({p.returncode}):\n{log[-4000:]}"
            outs.append(dict(np.load(spec["out"])))
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _jax_steps(data, tcfg):
    """The JAX package's single-device step (its Trainer's CPU path: the XLA
    model, RMSE + l2, optax Adam) at dropout 0 on the same global batches."""
    jcfg = JaxModelConfig(**TINY)
    model = JaxScannModel(config=jcfg)
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-7)

    @jax.jit
    def step(params, opt, batch, y, lr):
        def loss_fn(p):
            pred = model.apply({"params": p}, batch, deterministic=True)["property"][:, 0]
            return jnp.sqrt(jnp.mean((pred - y) ** 2)) + jax_l2_penalty(p, 1e-4)

        loss, g = jax.value_and_grad(loss_fn)(params)
        upd, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, jax.tree.map(lambda u: -lr * u, upd)), opt, loss

    params = data["jax_params"]
    opt = tx.init(params)
    losses = []
    for i, (name, k) in enumerate((n, k) for n in ("fused", "loop") for k in range(2)):
        rows = data[f"{name}_rows"][k]
        batch = {key.split("/", 1)[1]: v[rows] for key, v in data.items()
                 if key.startswith(f"{name}/")}
        params, opt, loss = step(params, opt, batch, jnp.asarray(data[f"{name}_targets"][rows]),
                                 float(data["lrs"][i]))
        losses.append(float(loss))
    return losses, params_from_jax(jax.device_get(params), tcfg)


def test_torch_two_gloo_ranks_train_as_ordered_shards(tmp_path):
    rng = np.random.default_rng(7)
    tcfg = ModelConfig(**TINY)
    fused = make_synthetic_batch(rng, B=32, M=16, N=8)
    loop = make_synthetic_batch(rng, B=32, M=72, N=8)
    jparams = jax.device_get(jit_init_vars(JaxScannModel(config=JaxModelConfig(**TINY)),
                                           jax.random.PRNGKey(0), fused)["params"])
    data = {"model": json.dumps(TINY), "lrs": np.array([5e-4, 4e-4, 5e-4, 3e-4]),
            "seeds": np.array([11, 12])}
    for name, x in (("fused", fused), ("loop", loop)):
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

    # both ranks hold the same state; rank 0 alone wrote the run directory
    assert int(r0["world"]) == int(r1["world"]) == 2
    for k in r0:
        if k.startswith("ranks/"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert int(r0["metrics_lines"]) == int(r1["metrics_lines"]) == 1
    assert bool(r0["checkpoint"]) and bool(r1["checkpoint"])
    for r in (r0, r1):
        assert "replica mismatch for 'a diverging tree'" in str(r["diverged"])
    assert [str(r0[f"ranks/det_route{i}"]) for i in range(4)] == ["fused"] * 2 + ["loop"] * 2

    # bit for bit: one process running the same shards in rank order, for
    # the Trainer and for the five make_sharded_* wrappers
    wrapped = [k for k in r0 if k.startswith("wrap/")]
    assert len(wrapped) == 2 * (1 + 2 + 2 * len(param_shapes(tcfg))) + 2
    for k in wrapped:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        np.testing.assert_array_equal(r0[k], one[k], err_msg=k)
    names = [k[len("ranks/"):] for k in r0 if k.startswith("ranks/")]
    assert len([n for n in names if n.startswith("fit_param/")]) == len(param_shapes(tcfg))
    for n in names:
        np.testing.assert_array_equal(r0[f"ranks/{n}"], one[f"ordered/{n}"], err_msg=n)

    # the whole batch in one process: within 1e-4
    for n in names:
        got, want = r0[f"ranks/{n}"], one[f"whole/{n}"]
        if "loss" in n or "mae" in n:
            np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=n)
        elif got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-4 * float(np.abs(want).max()), err_msg=n)

    # the JAX package's single-device step on the same global batches
    jax_losses, jax_final = _jax_steps(dict(data, jax_params=jparams), tcfg)
    np.testing.assert_allclose([float(r0[f"ranks/det_loss{i}"]) for i in range(4)], jax_losses,
                               rtol=1e-4)
    for k, r in jax_final.items():
        np.testing.assert_allclose(r0[f"ranks/det_param/{k}"], r.numpy(), rtol=0,
                                   atol=1e-4 * float(r.abs().max()), err_msg=k)

