"""Training CLI of the PyTorch port, with the JAX package's flags:

    python -m scann_tpu_torch.cli.train <target> <config.yaml> \\
        [--use_ring] [--use_ref] [--use_drop] [--feature atomic|cgcnn] \\
        [--pretrained W.h5] [--mode train|eval] [--epochs N] [--resume] \\
        [--structure-packing] [--profile LOGDIR] [--device cuda]

Flags merge into the config as in the reference ``train.py:37-43``. The
run directory (``{save_path}_{target}``) gets config.yaml, metrics.jsonl,
checkpoints/{best,last}.pt, report.txt and hist_data.json.
``--structure-packing`` sets ``tpu.structure_packing``: several structures
per slot (``data/packing.py``). ``--profile LOGDIR`` writes a
``torch.profiler`` Chrome trace of the training run under LOGDIR
(``utils.trace``). The flags of parts not ported yet (--exec-cache,
--distributed) are accepted and refused with a message.
"""

import argparse
import os
import random
import time

import numpy as np


def set_seed(seed: int = 0):
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a SCANN model on the GPU")
    parser.add_argument("target", type=str, help="target property (e.g. homo)")
    parser.add_argument("dataset", type=str, help="path to config YAML")
    parser.add_argument("--use_ring", action="store_true",
                        help="use ring/aromatic extra embedding")
    parser.add_argument("--use_ref", action="store_true",
                        help="subtract reference energy from the target")
    parser.add_argument("--use_drop", action="store_true",
                        help="attention dropout during training")
    parser.add_argument("--feature", type=str, default="atomic", choices=["atomic", "cgcnn"])
    parser.add_argument("--pretrained", type=str, default="",
                        help="Keras H5 checkpoint to start from (weights only)")
    parser.add_argument("--mode", type=str, default="train", choices=["train", "eval"])
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--resume", action="store_true",
                        help="continue from the run's 'last' checkpoint")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--structure-packing", action="store_true",
                        help="bin-pack several structures per padded slot")
    parser.add_argument("--distributed", action="store_true", help="not ported yet")
    parser.add_argument("--exec-cache", type=str, nargs="?", const="auto", default=None,
                        metavar="DIR", help="not ported yet")
    parser.add_argument("--profile", type=str, default=None, metavar="LOGDIR",
                        help="write a torch.profiler Chrome trace of training to LOGDIR")
    args = parser.parse_args(argv)
    for name in ("distributed", "exec_cache"):
        if getattr(args, name):
            parser.error(f"--{name.replace('_', '-')} is not ported to the PyTorch port yet")

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import load_config

    set_seed(0)
    config = load_config(args.dataset)
    config.model.feature = args.feature
    config.model.use_ring = args.use_ring
    config.model.use_drop = args.use_drop
    config.hyper.use_ref = args.use_ref
    config.hyper.target = args.target
    config.hyper.pretrained = args.pretrained
    if args.structure_packing:
        config.tpu.structure_packing = True

    scann = Scann(config, pretrained=args.pretrained, device=args.device)
    print(f"Loading dataset for target {args.target}")
    scann.prepare_dataset()
    if args.mode == "train":
        print("Training")
        t0 = time.time()
        if args.profile:
            from scann_tpu_torch.utils import trace

            with trace(args.profile):
                scann.train(args.epochs, resume=args.resume)
        else:
            scann.train(args.epochs, resume=args.resume)
        print(f"Training time: {time.time() - t0:.1f}s")
    print("Evaluating")
    scann.evaluate()


if __name__ == "__main__":
    main()
