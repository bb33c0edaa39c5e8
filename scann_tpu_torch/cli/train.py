"""Training CLI of the PyTorch port, with the JAX package's flags:

    python -m scann_tpu_torch.cli.train <target> <config.yaml> \\
        [--use_ring] [--use_ref] [--use_drop] [--feature atomic|cgcnn] \\
        [--pretrained W.h5|RUN_DIR|CKPT] [--mode train|eval] [--epochs N] [--resume] \\
        [--structure-packing] [--profile LOGDIR] [--device cuda] \\
        [--exec-cache [DIR]] [--distributed]

Flags merge into the config as in the reference ``train.py:37-43``. The
run directory (``{save_path}_{target}``) gets config.yaml, metrics.jsonl,
checkpoints/{best,last}.pt, report.txt and hist_data.json.
``--pretrained`` takes what ``Scann.load_pretrained`` takes: a reference
Keras H5 file (its weights), or a run directory or checkpoint
(``<run>/checkpoints/<name>[.pt]``) of this package (parameters, Adam state
and step).
``--structure-packing`` sets ``tpu.structure_packing``: several structures
per slot (``data/packing.py``). ``--profile LOGDIR`` writes a
``torch.profiler`` Chrome trace of the training run under LOGDIR
(``utils.trace``). ``--exec-cache [DIR]`` sets ``tpu.exec_cache_dir`` (default
``{save_path}/exec_cache``): the kernels are built there, or loaded from
there when an earlier run built them (``utils/exec_cache.py``).
``--distributed`` joins a data-parallel job before any CUDA use
(``parallel.initialize``: one process a GPU, e.g. ``torchrun
--nproc-per-node 4 -m scann_tpu_torch.cli.train ... --distributed``, or
``SCANN_TPU_COORDINATOR`` / ``SCANN_TPU_NUM_PROCESSES`` /
``SCANN_TPU_PROCESS_ID``; ``SCANN_TPU_DISTRIBUTED=1`` engages it too); each
rank drives ``cuda:{LOCAL_RANK}`` and rank 0 writes the run directory.
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
                        help="start from a Keras H5 file (weights) or a run directory or "
                             "checkpoints/<name>[.pt] of this package (weights, Adam "
                             "state and step)")
    parser.add_argument("--mode", type=str, default="train", choices=["train", "eval"])
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--resume", action="store_true",
                        help="continue from the run's 'last' checkpoint")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--structure-packing", action="store_true",
                        help="bin-pack several structures per padded slot")
    parser.add_argument("--distributed", action="store_true",
                        help="data parallelism over torch.distributed, one process a GPU: "
                             "join the job (torchrun's env or SCANN_TPU_COORDINATOR / "
                             "SCANN_TPU_NUM_PROCESSES / SCANN_TPU_PROCESS_ID) before any "
                             "CUDA use")
    parser.add_argument("--exec-cache", type=str, nargs="?", const="auto", default=None,
                        metavar="DIR",
                        help="build the kernels into DIR (default {save_path}/exec_cache), "
                             "or load them from there when an earlier run built them")
    parser.add_argument("--profile", type=str, default=None, metavar="LOGDIR",
                        help="write a torch.profiler Chrome trace of training to LOGDIR")
    args = parser.parse_args(argv)

    # join the job before any CUDA use; the explicit flag overrides a
    # launcher's SCANN_TPU_DISTRIBUTED=0
    if args.distributed:
        os.environ["SCANN_TPU_DISTRIBUTED"] = "1"
    from scann_tpu_torch.parallel import initialize, make_mesh

    initialize(backend="gloo" if args.device == "cpu" else None)
    mesh = make_mesh()

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
    if args.exec_cache:
        config.tpu.exec_cache_dir = (os.path.join(config.hyper.save_path, "exec_cache")
                                     if args.exec_cache == "auto" else args.exec_cache)

    scann = Scann(config, pretrained=args.pretrained, device=args.device, mesh=mesh)
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
