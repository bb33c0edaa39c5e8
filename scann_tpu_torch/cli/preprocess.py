"""Dataset preprocessing CLI of the PyTorch port, with the JAX package's
arguments (the reference ``preprocess_data.py``'s):

    python -m scann_tpu_torch.cli.preprocess <dataset> <save_path> \\
        [--dt 4.0] [--wt 0.4] [--p 8]

Datasets: qm9, qm9_std_jctc, fullerene, ptgp, smfe, mp2018, and
``synthetic`` (made offline, no download). Builds
``{ds}/{ds}_data_energy.npy`` under save_path unless it exists, then the
Voronoi neighbour cache ``{ds}_data_neighbor_dt{dt}_wt{wt}.npy`` beside it
on ``--p`` processes (naming per reference ``preprocess_data.py:31-36``).
It runs on the host alone and needs no GPU.
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="Preprocess a dataset")
    parser.add_argument("dataset", type=str,
                        help="qm9 | qm9_std_jctc | fullerene | ptgp | smfe | "
                             "mp2018 | synthetic")
    parser.add_argument("save_path", type=str)
    parser.add_argument("--dt", type=float, default=4.0, help="distance cutoff (A)")
    parser.add_argument("--wt", type=float, default=0.4, help="solid-angle cutoff")
    parser.add_argument("--p", type=int, default=8, help="process-pool size")
    args = parser.parse_args(argv)

    from scann_tpu_torch.data import builders
    from scann_tpu_torch.data.featurize import neighbor_file_name, parallel_compute_neighbors

    build_fns = builders.BUILDERS
    if args.dataset not in build_fns:
        raise SystemExit(f"unknown dataset {args.dataset!r}; "
                         f"choose from {sorted(build_fns)}")

    ds_dir = os.path.join(args.save_path, args.dataset)
    energy_path = os.path.join(ds_dir, f"{args.dataset}_data_energy.npy")
    if not os.path.exists(energy_path):
        print(f"Building dataset {args.dataset} -> {ds_dir}")
        build_fns[args.dataset](args.save_path)
    else:
        print(f"Dataset exists: {energy_path}")

    nbr_path = os.path.join(ds_dir, neighbor_file_name(args.dataset, args.dt, args.wt))
    parallel_compute_neighbors(energy_path, nbr_path, d_t=args.dt, w_t=args.wt,
                               pool=args.p)


if __name__ == "__main__":
    main()
