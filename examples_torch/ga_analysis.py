"""Dataset-level GA-score interpretability analysis with the PyTorch port
(the port's twin of ``examples/ga_analysis.py``, script form of the
reference's ``notebooks/sm_pretrained.ipynb`` SmFe12 workflow).

Runs a model trained by the port over a whole preprocessed dataset, then
summarizes which chemical environments the model attends to:

- per-element GA-score statistics (mean/std of attention share, normalized
  by 1/n_atoms so 1.0 = uniform attention),
- the GA-ratio vs target correlation per element (the paper's
  interpretability signal: e.g. attention concentrating on dopant sites in
  low-formation-energy SmFe12 structures),
- a CSV dump for plotting, in the JAX script's header and row format.

The model runs on the GPU (``--device cuda``, the default: the forward
kernels) and raises without one, unless ``--device cpu`` asks for the CPU.

    python examples_torch/ga_analysis.py RUN_DIR [--out ga_analysis.csv]
"""

import argparse
import collections
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(argv=None):
    """Prints and writes as the JAX script does; returns the dataset's
    (predictions, GA scores) in dataset order."""
    parser = argparse.ArgumentParser()
    parser.add_argument("model_dir", help="training run dir of the port (checkpoints/best.pt)")
    parser.add_argument("--out", default="ga_analysis.csv")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the eager model)")
    args = parser.parse_args(argv)

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.data.atomic_data import chemical_symbols
    from scann_tpu_torch.data.pipeline import load_dataset

    scann = Scann.load_model_infer(args.model_dir, device=args.device)
    hyper = scann.config.hyper
    buckets = scann.prepare_dataset(split=False)
    preds, gas = scann.predict_data(buckets, with_ga=True)

    records, _ = load_dataset(hyper.data_energy_path, hyper.data_nei_path,
                              hyper.target, use_ref=hyper.use_ref,
                              use_ring=scann.config.model.use_ring)

    # per-element attention share, normalized so uniform attention == 1.0
    elem_ratios = collections.defaultdict(list)
    per_structure = []
    for i, (rec, ga) in enumerate(zip(records, gas)):
        n = len(rec["atomic"])
        ratios = ga * n  # uniform -> 1.0
        for z, r in zip(rec["atomic"], ratios):
            elem_ratios[chemical_symbols[int(z)]].append(float(r))
        per_structure.append((i, preds[i], rec["target"],
                              {chemical_symbols[int(z)]: float((ratios[rec["atomic"] == z]).mean())
                               for z in np.unique(rec["atomic"])}))

    print(f"{len(records)} structures; target {hyper.target}")
    print(f"prediction MAE vs stored targets: "
          f"{np.mean(np.abs(preds - np.array([r['target'] for r in records]))):.6f}")
    print("\nper-element GA attention share (1.0 = uniform):")
    print(f"{'elem':>5} {'count':>8} {'mean':>8} {'std':>8}")
    for el in sorted(elem_ratios, key=lambda e: -np.mean(elem_ratios[e])):
        v = np.asarray(elem_ratios[el])
        print(f"{el:>5} {len(v):>8} {v.mean():>8.3f} {v.std():>8.3f}")

    with open(args.out, "w") as f:
        elems = sorted(elem_ratios)
        f.write("structure,prediction,target," +
                ",".join(f"ga_ratio_{e}" for e in elems) + "\n")
        for i, pred, target, ratios in per_structure:
            row = [str(i), f"{pred:.6f}", f"{target:.6f}"]
            row += [f"{ratios.get(e, float('nan')):.4f}" for e in elems]
            f.write(",".join(row) + "\n")
    print(f"\nwrote {args.out}")
    return preds, gas


if __name__ == "__main__":
    main()
