"""Export a run of the PyTorch port as a reference-layout Keras H5:

    python -m scann_tpu_torch.cli.export <model_dir> <out.h5> [--device cuda]

Loads the run directory's best checkpoint (``checkpoints/best.pt``, which
carries its config) onto the device and writes the weights in the
reference's ``model_weights`` H5 layout (reference
``scann_model.py:165-177`` is what its ModelCheckpoint produces), so the
model can be handed to reference-ecosystem tooling or to the JAX package.
The inverse of training with ``--pretrained``. Needs h5py.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("model_dir", type=str,
                        help="training run directory (checkpoints/best.pt)")
    parser.add_argument("out", type=str, help="output .h5 path")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    try:
        import h5py  # noqa: F401
    except ImportError:
        parser.error("writing an H5 file needs the h5py package, which is not installed")

    from scann_tpu_torch.api import Scann

    scann = Scann.load_model_infer(args.model_dir, device=args.device)
    scann.export_h5(args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
