"""Single-file inference CLI of the PyTorch port, with GA-score output.

    python -m scann_tpu_torch.cli.predict_files <model_dir> <save_path> <file.xyz...> \\
        [--mol] [--dt 4.0] [--wt 0.4] [--device cuda]
    python -m scann_tpu_torch.cli.predict_files --config X.yaml --weights W.h5 \\
        <save_path> <file.xyz...> [...]

The model is a training run directory of this package (``checkpoints/best.pt``,
as ``scann_tpu.cli.predict_files`` takes the JAX package's), or a config and
a Keras H5 checkpoint. For each input structure, predicts the target property and writes
``<save_path>/<name>_ga.xyz`` with per-atom GA scores as an extra column
(the format the JAX package's ``predict_files`` writes), plus
``<save_path>/predictions.json``.
"""

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("paths", nargs="+", metavar="[model_dir] save_path file",
                        help="the training run dir (unless --config and --weights are "
                             "given), the output dir, then the structure files")
    parser.add_argument("--config", help="model config YAML (with --weights)")
    parser.add_argument("--weights", help="Keras H5 checkpoint (with --config)")
    parser.add_argument("--mol", action="store_true",
                        help="accepted for reference-CLI compatibility; molecules are "
                             "boxed during featurization")
    parser.add_argument("--dt", type=float, default=4.0)
    parser.add_argument("--wt", type=float, default=0.4)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    from_files = args.config is not None and args.weights is not None
    if (args.config is None) != (args.weights is None):
        parser.error("--config and --weights go together")
    paths = list(args.paths)
    model_dir = None if from_files else paths.pop(0)
    if len(paths) < 2:
        parser.error("need a save_path and at least one structure file")
    save_path, files = paths[0], paths[1:]

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.data.structure import Structure

    if from_files:
        scann = Scann(args.config, pretrained=args.weights, device=args.device)
    else:
        scann = Scann.load_model_infer(model_dir, device=args.device)
    os.makedirs(save_path, exist_ok=True)

    results = {}
    for path in files:
        struct = Structure.from_file(path)
        value, ga = scann.predict_structure(struct, d_t=args.dt, w_t=args.wt)
        name = os.path.splitext(os.path.basename(path))[0]
        if name in results:  # same basename from two directories
            k = 2
            while f"{name}_{k}" in results:
                k += 1
            name = f"{name}_{k}"
        out_xyz = os.path.join(save_path, f"{name}_ga.xyz")
        struct.to_xyz(out_xyz, extra_columns=ga)
        results[name] = {"prediction": value, "ga_scores": ga.tolist()}
        print(f"{name}: {scann.config.hyper.target} = {value:.6f} -> {out_xyz}")

    with open(os.path.join(save_path, "predictions.json"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
