"""Batched-inference HTTP server CLI of the PyTorch port.

    python -m scann_tpu_torch.cli.serve <model_dir>
        [--host 127.0.0.1] [--port 8421] [--max-batch 64] [--window-ms 5]
        [--device cuda] [--exec-cache [DIR]]
    python -m scann_tpu_torch.cli.serve --config X.yaml --weights W.h5 [...]

Serves a training run directory of this package (``checkpoints/best.pt``,
as ``scann_tpu.cli.serve`` takes the JAX package's), or a config and a Keras
H5 checkpoint, over HTTP on the GPU; see ``scann_tpu_torch.serve`` for the
request/response format. A run directory needs neither yaml nor h5py.
``--exec-cache [DIR]`` builds the kernels into DIR (default
``{model_dir}/exec_cache``) or loads them from there when an earlier
process built them (``Scann.enable_exec_cache``).
"""

import argparse


def parse_shapes(text: str):
    shapes = []
    for part in text.split(","):
        m, n = part.lower().split("x")
        shapes.append((int(m), int(n)))
    return shapes


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("model_dir", nargs="?", default=None,
                        help="training run dir (checkpoints/best.pt)")
    parser.add_argument("--config", help="model config YAML (with --weights)")
    parser.add_argument("--weights", help="Keras H5 checkpoint (with --config)")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8421)
    parser.add_argument("--max-batch", type=int, default=64)
    parser.add_argument("--window-ms", type=float, default=5.0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--featurize-pool", type=int, default=0,
                        help="featurize coalesced batches across N worker processes")
    parser.add_argument("--warmup", type=str, default="",
                        help="comma-separated MxN shapes (atoms x neighbors) to run "
                             "once before accepting requests, e.g. '30x14,48x16'. "
                             "Default: the model's recorded tpu.observed_buckets")
    parser.add_argument("--exec-cache", type=str, nargs="?", const="auto", default=None,
                        metavar="DIR",
                        help="build the kernels into DIR (default {model_dir}/exec_cache), "
                             "or load them from there when an earlier process built them")
    parser.add_argument("--no-canonical-frame", dest="canonical_frame",
                        action="store_false",
                        help="serve raw client frames instead of rotating molecules "
                             "into their principal-axes frame first")
    args = parser.parse_args(argv)
    if (args.model_dir is None) == (args.config is None or args.weights is None):
        parser.error("give either a model_dir or both --config and --weights")

    from scann_tpu_torch.serve import BatchedPredictor, PredictionServer

    warmup = None
    if args.warmup:
        try:
            warmup = parse_shapes(args.warmup)
        except ValueError:
            parser.error(f"--warmup must look like '30x14,48x16', got {args.warmup!r}")

    kw = dict(device=args.device, max_batch=args.max_batch, window_ms=args.window_ms,
              featurize_pool=args.featurize_pool, canonical_frame=args.canonical_frame,
              warmup_shapes=warmup, exec_cache=args.exec_cache)
    if args.model_dir is not None:
        predictor = BatchedPredictor.from_model_dir(args.model_dir, **kw)
    else:
        predictor = BatchedPredictor.from_files(args.config, args.weights, **kw)
    if predictor.warmed:
        print(f"warmed serving shapes: {predictor.warmed}")
    server = PredictionServer(predictor, host=args.host, port=args.port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
