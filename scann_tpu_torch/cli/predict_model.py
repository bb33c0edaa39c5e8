"""Full-dataset inference CLI of the PyTorch port.

    python -m scann_tpu_torch.cli.predict_model <model_dir> [--out DIR] [--device cuda]

Runs a trained model (``<model_dir>/checkpoints/best.pt``) over its
configured dataset and writes ``energy_pre_{target}.pickle`` (predictions
and targets in dataset order) and ``ga_scores_{target}.pickle`` (per-atom
GA scores), the files of the reference ``predict_model.py:50-92``.
"""

import argparse
import os
import pickle

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("model_dir", type=str)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from scann_tpu_torch.api import Scann

    scann = Scann.load_model_infer(args.model_dir, device=args.device)
    buckets = scann.prepare_dataset(split=False)
    preds, gas = scann.predict_data(buckets, with_ga=True)

    hyper = scann.config.hyper
    order = np.concatenate([np.asarray(b.indices) for b in buckets])
    targets = np.concatenate([np.asarray(b.targets, np.float64) for b in buckets])
    t = np.zeros(len(order), np.float64)
    t[order] = targets * hyper.target_std + hyper.target_mean

    out_dir = args.out or args.model_dir
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"energy_pre_{hyper.target}.pickle"), "wb") as f:
        pickle.dump({"prediction": preds, "target": t}, f)
    with open(os.path.join(out_dir, f"ga_scores_{hyper.target}.pickle"), "wb") as f:
        pickle.dump(gas, f)
    mae = float(np.mean(np.abs(preds - t)))
    print(f"{len(preds)} structures, MAE {mae:.6f} -> {out_dir}")


if __name__ == "__main__":
    main()
