"""Single-file inference CLI of the PyTorch port, with GA-score output.

    python -m scann_tpu_torch.cli.predict_files --config X.yaml --weights W.h5 \\
        <save_path> <file.xyz...> [--dt 4.0] [--wt 0.4] [--device cuda]

For each input structure, predicts the target property and writes
``<save_path>/<name>_ga.xyz`` with per-atom GA scores as an extra column
(the format the JAX package's ``predict_files`` writes), plus
``<save_path>/predictions.json``.
"""

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, help="model config YAML")
    parser.add_argument("--weights", required=True, help="Keras H5 checkpoint")
    parser.add_argument("save_path", type=str)
    parser.add_argument("files", nargs="+", type=str)
    parser.add_argument("--dt", type=float, default=4.0)
    parser.add_argument("--wt", type=float, default=0.4)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.data.structure import Structure

    scann = Scann(args.config, pretrained=args.weights, device=args.device)
    os.makedirs(args.save_path, exist_ok=True)

    results = {}
    for path in args.files:
        struct = Structure.from_file(path)
        value, ga = scann.predict_structure(struct, d_t=args.dt, w_t=args.wt)
        name = os.path.splitext(os.path.basename(path))[0]
        if name in results:  # same basename from two directories
            k = 2
            while f"{name}_{k}" in results:
                k += 1
            name = f"{name}_{k}"
        out_xyz = os.path.join(args.save_path, f"{name}_ga.xyz")
        struct.to_xyz(out_xyz, extra_columns=ga)
        results[name] = {"prediction": value, "ga_scores": ga.tolist()}
        print(f"{name}: {scann.config.hyper.target} = {value:.6f} -> {out_xyz}")

    with open(os.path.join(args.save_path, "predictions.json"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
