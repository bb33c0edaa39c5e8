"""Load a published Keras H5 SCANN checkpoint and run inference + GA scores
with the PyTorch port (the port's twin of ``examples/pretrained_h5.py``,
script form of the reference ``notebooks/qm9_pretrained.ipynb``).

    python examples_torch/pretrained_h5.py CONFIG.yaml MODEL.h5 mol1.xyz [mol2.xyz ...]
    python examples_torch/pretrained_h5.py CONFIG.yaml MODEL.h5 mol.xyz --device cpu

The H5 is converted to the port's parameters on the fly
(``scann_tpu_torch.compat``); no TensorFlow needed at inference time. The
model runs on the GPU (``--device cuda``, the default: the whole-model
forward kernels) and raises without one, unless ``--device cpu`` asks for
the eager model on the CPU.

Reading the H5 needs h5py, and a YAML config needs yaml (a JSON config is
read by yaml too). A machine without them cannot run this script: run it
where both are installed.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", help="experiment YAML (e.g. configs/model_qm9.yaml)")
    parser.add_argument("h5", help="Keras H5 checkpoint")
    parser.add_argument("files", nargs="+", help="xyz structure files")
    parser.add_argument("--dt", type=float, default=4.0)
    parser.add_argument("--wt", type=float, default=0.4)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the eager model)")
    args = parser.parse_args(argv)

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.data.structure import Structure

    scann = Scann(args.config, pretrained=args.h5, device=args.device)
    target = scann.config.hyper.target

    for path in args.files:
        struct = Structure.from_file(path)
        value, ga = scann.predict_structure(struct, d_t=args.dt, w_t=args.wt)
        name = os.path.basename(path)
        print(f"{name}: {target} = {value:.6f}")
        top = ga.argsort()[::-1][:5]
        tops = ", ".join(f"{struct.species[i]}{i}={ga[i]:.3f}" for i in top)
        print(f"  top GA: {tops}")


if __name__ == "__main__":
    main()
