"""Subprocess worker for tests/test_torch_distributed.py.

``--mode ranks``: one rank of a ``--world``-process gloo job on the CPU
(``parallel.initialize``). ``--mode single``: one process without a group,
which runs the same work twice: with its steps and eval batches split into
the ranks' shards and run one after another in rank order (gradients summed
from rank 0 up), and on the whole batch. Either way the Trainer:

1. takes 2 steps on each of two buckets at dropout 0 (a molecule bucket on
   the "fused" route, a crystal bucket on the "loop" route) and evaluates a
   batch of each;
2. ``fit``s one epoch on the same buckets at the training dropout (2 steps
   a bucket, eval on the first), writing the run directory;

then it calls the five ``make_sharded_*`` wrappers at dropout 0.1 (in
``single`` mode: the JAX-signature functions on each shard in rank order),
and writes losses, parameters, predictions and gradients to ``--out``
(npz) for the parent test to compare. Invoked as a script, never imported
by pytest.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("ranks", "single"), required=True)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--data", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch

    torch.set_num_threads(1)      # the plain backward sums in one order
    from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig
    from scann_tpu_torch.data.pipeline import PackedBucket
    from scann_tpu_torch.kernels import sharded
    from scann_tpu_torch.kernels.sharded import local_rows
    from scann_tpu_torch.parallel import RankLayout, check_replicas_match, initialize
    from scann_tpu_torch.train.loop import Trainer

    data = np.load(args.data)
    model = ModelConfig(**json.loads(str(data["model"])))
    params0 = {k[len("param/"):]: torch.from_numpy(data[k]) for k in data.files
               if k.startswith("param/")}
    buckets = {}
    for name in ("fused", "loop"):
        inputs = {k.split("/", 1)[1]: data[k] for k in data.files
                  if k.startswith(f"{name}/")}
        buckets[name] = PackedBucket(inputs, data[f"{name}_targets"],
                                     np.arange(len(data[f"{name}_targets"])))
    steps = [(name, data[f"{name}_rows"][k], float(data["lrs"][i]), int(data["seeds"][k]))
             for i, (name, k) in enumerate((n, k) for n in ("fused", "loop") for k in range(2))]
    cfg = lambda: ScannConfig(model=model, hyper=HyperConfig(batch_size=16, epochs=1,
                                                             scheduler="sgdr", seed=0))

    def ordered(trainer, world):
        """Run the trainer's steps and eval batches as ``world`` shards one
        after another in rank order, in this one process."""
        def raw_grads(batch, y, seed):
            route = trainer.train_route(batch["atomic"].shape[1], batch["neighbors"].shape[2])
            preds, total = [], None
            for r in range(world):
                rows, x = local_rows(RankLayout(world, r, trainer.device), batch)
                pred, g = trainer._whole_model_grads(route, x, y[rows], seed, rows.start)
                preds.append(pred)
                total = g if total is None else {k: total[k] + g[k] for k in total}
            return torch.cat(preds), total

        def eval_batch(batch):
            outs = [trainer.forward_eval(trainer.params,
                                         local_rows(RankLayout(world, r, trainer.device),
                                                    batch)[1]) for r in range(world)]
            return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

        trainer.raw_grads, trainer.eval_batch = raw_grads, eval_batch
        return trainer

    def run(make, tag, out):
        t = make(Trainer(cfg(), "cpu", os.path.join(args.workdir, tag)))
        t.load_params(params0)
        t.dropout_rate = 0.0
        for i, (name, rows, lr, seed) in enumerate(steps):
            b = buckets[name]
            batch = {k: torch.from_numpy(v[rows]) for k, v in b.inputs.items()}
            loss, mae = t.train_step(batch, torch.from_numpy(b.targets[rows]), lr, seed)
            out[f"{tag}/det_loss{i}"] = float(loss)
            out[f"{tag}/det_mae{i}"] = float(mae)
            out[f"{tag}/det_route{i}"] = t.train_route(*b.shape)
        for name, b in buckets.items():
            pred, ga = t.eval_batch({k: torch.from_numpy(v[:16]) for k, v in b.inputs.items()})
            out[f"{tag}/eval_pred/{name}"], out[f"{tag}/eval_ga/{name}"] = pred, ga
        out.update({f"{tag}/det_param/{k}": v for k, v in t.params.items()})

        t = make(Trainer(cfg(), "cpu", os.path.join(args.workdir, tag)))
        t.load_params(params0)
        hist = t.fit([buckets["fused"], buckets["loop"]], [buckets["fused"]], log_fn=lambda m: 0)
        out[f"{tag}/fit_loss"], out[f"{tag}/fit_val_mae"] = hist["loss"], hist["val_mae"]
        out.update({f"{tag}/fit_param/{k}": v for k, v in t.params.items()})
        return t

    def wrappers(out, mesh=None):
        """The five ``make_sharded_*`` wrappers on 16 rows of each bucket
        (``mesh``), or their reference: the JAX-signature function on each
        of ``args.world`` shards in rank order, outputs concatenated and
        gradients added from rank 0 up."""
        rate, seed = 0.1, 5
        for kind, bucket, fn in (("scann", "fused", "fused_scann"), ("loop", "loop", "loop_scann")):
            b = buckets[bucket]
            x = {k: torch.from_numpy(v[:16]) for k, v in b.inputs.items()}
            y = torch.from_numpy(b.targets[:16])
            leaves = {k: v.clone().requires_grad_(True) for k, v in params0.items()}
            if mesh is not None:
                pred, raw = getattr(sharded, f"make_sharded_{kind}_train")(
                    mesh, model, False, rate)(params0, x, y, seed)
                p, ga = getattr(sharded, f"make_sharded_{kind}_apply")(
                    mesh, model, False, rate)(leaves, x, seed)
                loss = (p ** 2).sum() + ga.sum()
                agrad = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
                if kind == "loop":
                    fp, fga = sharded.make_sharded_loop_forward(mesh, model)(params0, x)
            else:
                shards = [local_rows(RankLayout(args.world, r, torch.device("cpu")), x)
                          for r in range(args.world)]
                train, fwd, grad = (getattr(sharded, f"{fn}_{what}")
                                    for what in ("train_grads", "forward", "grad"))
                outs = [train(params0, xr, y[rows].reshape(-1, 1), model, False, rate, seed,
                              mol_base=rows.start) for rows, xr in shards]
                pred = torch.cat([o[0] for o in outs])
                raw = {k: sum((o[1][k] for o in outs[1:]), outs[0][1][k]) for k in params0}
                fw = [fwd(params0, xr, model, False, rate, seed, mol_base=rows.start)
                      for rows, xr in shards]
                p, ga = torch.cat([f[0] for f in fw]), torch.cat([f[1] for f in fw])
                gs = [grad(params0, xr, model, 2 * f[0], torch.ones_like(f[1]), rate, seed,
                           mol_base=rows.start) for (rows, xr), f in zip(shards, fw)]
                agrad = {k: sum((g[k] for g in gs[1:]), gs[0][k]) for k in params0}
                if kind == "loop":
                    fo = [sharded.loop_scann_forward(params0, xr, model) for _, xr in shards]
                    fp, fga = torch.cat([f[0] for f in fo]), torch.cat([f[1] for f in fo])
            out[f"wrap/{kind}_train_pred"] = pred
            out[f"wrap/{kind}_apply_pred"], out[f"wrap/{kind}_apply_ga"] = p, ga
            out.update({f"wrap/{kind}_train_grad/{k}": v for k, v in raw.items()})
            out.update({f"wrap/{kind}_apply_grad/{k}": v for k, v in agrad.items()})
        out["wrap/loop_forward_pred"], out["wrap/loop_forward_ga"] = fp, fga

    out = {}
    if args.mode == "ranks":
        assert initialize(args.coordinator, args.world, args.rank, backend="gloo")
        t = run(lambda t: t, "ranks", out)
        out["world"] = t.mesh.world
        wrappers(out, t.mesh)
        torch.distributed.barrier()
        run_dir = t.workdir
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            out["metrics_lines"] = len(f.readlines())
        out["checkpoint"] = os.path.exists(os.path.join(run_dir, "checkpoints", "last.pt"))
        try:
            check_replicas_match({"x": np.arange(4) + args.rank}, what="a diverging tree")
            out["diverged"] = "not detected"
        except RuntimeError as e:
            out["diverged"] = str(e)
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    else:
        run(lambda t: ordered(t, args.world), "ordered", out)
        run(lambda t: t, "whole", out)
        wrappers(out)
    np.savez(args.out, **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                              else np.asarray(v)) for k, v in out.items()})


if __name__ == "__main__":
    main()
