"""GA-score interpretability walkthrough with the PyTorch port (the port's
twin of ``examples/interpretability.py``, script form of the reference's
``notebooks/qm9_pretrained.ipynb`` workflow).

Loads a model trained by the port (a run directory of
``scann_tpu_torch``: ``checkpoints/best.pt``, which holds its config, so no
yaml is needed), runs single-structure inference on xyz files, and writes:

- per-atom GA scores printed next to the species,
- ``<name>_ga.xyz`` with the GA score as a 5th column (load in OVITO and
  color by the extra property to reproduce the paper's attention maps).

Offline demo (no checkpoint): trains a small model on synthetic data first.
The model runs on the GPU (``--device cuda``, the default) and raises
without one, unless ``--device cpu`` asks for the CPU.

    python examples_torch/interpretability.py --model-dir RUN_DIR mol1.xyz ...
    python examples_torch/interpretability.py --demo mol.xyz
    python examples_torch/interpretability.py --demo mol.xyz --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def demo_model(workdir: str, device: str = "cuda"):
    """Train a small SCANN+ on synthetic molecules, return a Scann handle."""
    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig
    from scann_tpu_torch.data.synthetic import make_synthetic_dataset

    data_dir = os.path.join(workdir, "data")
    e, n = make_synthetic_dataset(data_dir, n_structures=256, min_atoms=5,
                                  max_atoms=16, seed=0)
    cfg = ScannConfig(
        model=ModelConfig(n_atoms=12, embedding_dim=16, n_attention=3,
                          local_dim=64, num_head=4, global_dim=64,
                          dense_out=32, g_update=True),
        hyper=HyperConfig(batch_size=32, lr=1e-3, min_lr=1e-4, epochs=40,
                          patience=100, target="homo",
                          data_energy_path=e, data_nei_path=n,
                          save_path=os.path.join(workdir, "model")),
    )
    scann = Scann(cfg, device=device)
    scann.prepare_dataset()
    scann.train()
    scann.trainer.restore_checkpoint("best")
    return scann


def main(argv=None):
    """Prints and writes as the JAX script does; returns {name: (value,
    GA scores)} of the structures in the order given."""
    parser = argparse.ArgumentParser()
    parser.add_argument("files", nargs="+", help="xyz structure files")
    parser.add_argument("--model-dir", default=None,
                        help="trained run dir of the port (checkpoints/best.pt)")
    parser.add_argument("--demo", action="store_true",
                        help="train a quick synthetic model instead")
    parser.add_argument("--out", default="ga_out")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the eager model)")
    args = parser.parse_args(argv)

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.data.structure import Structure

    if args.demo:
        scann = demo_model(os.path.join(args.out, "demo_model"), args.device)
    elif args.model_dir:
        scann = Scann.load_model_infer(args.model_dir, device=args.device)
    else:
        parser.error("need --model-dir or --demo")

    os.makedirs(args.out, exist_ok=True)
    results = {}
    for path in args.files:
        struct = Structure.from_file(path)
        value, ga = scann.predict_structure(struct)
        name = os.path.splitext(os.path.basename(path))[0]
        results[name] = (value, ga)
        print(f"\n{name}: predicted {scann.config.hyper.target} = {value:.6f}")
        print("  per-atom GA scores (higher = more attended):")
        order = ga.argsort()[::-1]
        for rank, i in enumerate(order[:10]):
            print(f"    #{rank + 1}: atom {i} ({struct.species[i]})  "
                  f"GA = {ga[i]:.4f}")
        out_xyz = os.path.join(args.out, f"{name}_ga.xyz")
        struct.to_xyz(out_xyz, extra_columns=ga)
        print(f"  wrote {out_xyz} (color by column 5 in OVITO)")
    return results


if __name__ == "__main__":
    main()
