"""High-level API of the PyTorch port (port of ``scann_tpu/api.py``).

``Scann`` holds one config and, in its ``Trainer``, one set of parameters
on one device. It trains and evaluates on a dataset pair:

    prepare_dataset (load, standardize, pad into (M, N) buckets or, with
      ``tpu.structure_packing``, bin-pack into slots of several structures;
      split)
      -> train (on the GPU one launch per step of the molecule backward
         kernel or, for crystal buckets, of the loop backward kernel; the
         plain model under autograd beyond both: ``Trainer.train_route``)
      -> evaluate / predict_data (the forward kernels)

and it predicts properties and per-atom GA scores for structures:

    featurize (host Voronoi, ``prepare_input``)
      -> pad and group by ladder-quantized (M, N) shape
      -> ``forward_eval`` in batches of at most ``hyper.batch_size`` (a
         group's last batch at its own size, its indices checked on the host)
         (on the GPU the molecule kernel, the crystal loop kernel or the
         per-layer kernel, by the batch's shape; the eager model on the CPU)
      -> un-standardize.

The device defaults to CUDA, and a missing CUDA device raises: nothing
falls back to the CPU unless the caller asks for ``device="cpu"``.
Weights come from training, a torch checkpoint of this package
(``load_model_infer``; ``load_pretrained`` of a run or checkpoint, with its
Adam state and step), a reference Keras H5 (``load_pretrained``, with
``with_optimizer=True`` its Adam state too) or any flax-layout tree
(``load_params``); ``export_h5`` writes the reference's H5 layout back. The
JAX package's orbax checkpoints (which need JAX to read) are not part of
the port. ``enable_exec_cache`` points the kernel build cache
(``utils/exec_cache.py``) at a directory, so a later process loads the
kernels this one built; ``mesh`` (``parallel.make_mesh``) trains one rank
of a data-parallel job over ``torch.distributed``.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.compat.from_jax import params_from_jax
from scann_tpu_torch.config import ScannConfig, load_config
from scann_tpu_torch.data import native_voronoi
from scann_tpu_torch.data.packing import pack_dataset_slots
from scann_tpu_torch.data.pipeline import (
    build_csr,
    load_dataset,
    pack_dataset,
    split_data,
    subset_buckets,
)
from scann_tpu_torch.data.structure import Structure
from scann_tpu_torch.data.voronoi import compute_voronoi_neighbors, native_voronoi_enabled
from scann_tpu_torch.models.scann import check_index_ranges
from scann_tpu_torch.train.loop import Trainer, _to_device

StructureLike = Union[Structure, str, os.PathLike]

# One INFO line, once a process, when canonical-frame serving first meets a
# molecule (``scann_tpu/api.py:58-80``): the default rotates molecules to their
# principal-axes frame, a deliberate output change from the reference's
# raw-frame featurization, and an operator should read that in the logs.
_CANONICAL_NOTICE_EMITTED = [False]


def _canonical_frame_notice(structs) -> None:
    if _CANONICAL_NOTICE_EMITTED[0]:
        return
    if not any(not s.is_periodic for s in structs):
        return  # periodic inputs are unaffected by construction
    _CANONICAL_NOTICE_EMITTED[0] = True
    import logging

    logging.getLogger(__name__).info(
        "canonical_frame=True (default since v0.4): molecule inputs are "
        "rotated to their principal-axes frame before featurization — "
        "predictions are frame-invariant but not bit-identical to the "
        "reference's raw-frame featurization. Pass canonical_frame=False "
        "(CLI: --no-canonical-frame) for reference-bit-compatible output. "
        "See CHANGELOG.md and benchmarks/canonical_frame_study.json.")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _ladder(x: int, base: int) -> int:
    """Quantize ``x`` up to a bounded geometric ladder of ``base`` multiples
    (base * {1,2,3,4,6,8,12,16,...}): a bounded set of padded shapes, at
    most ~33% padding."""
    steps = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128]
    for s in steps:
        if x <= base * s:
            return base * s
    return _round_up(x, base * steps[-1])


def _port_checkpoint(path: str) -> Optional[Tuple[str, str]]:
    """(run directory, checkpoint name) of a checkpoint of this package:
    ``<run>/checkpoints/<name>`` or ``<name>.pt`` (that name), or a run
    directory (its ``best``); None for anything else."""
    path = os.path.normpath(path)
    head, tail = os.path.split(path)
    if os.path.basename(head) == "checkpoints":
        name = tail[:-3] if tail.endswith(".pt") else tail
        if os.path.isfile(os.path.join(head, name + ".pt")):
            return os.path.dirname(head), name
        return None
    if os.path.isfile(os.path.join(path, "checkpoints", "best.pt")):
        return path, "best"
    return None


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device a user asked for; CUDA must exist when it is asked for.
    A bare ``"cuda"`` stays bare: the Trainer gives it the rank's card
    (``parallel.local_device``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' explicitly to run the eager model on the CPU")
    return dev


def prepare_input(
    struct: Structure,
    d_t: float = 4.0,
    w_t: float = 0.4,
    angle: bool = True,
    cutoff: float = 7.0,
    atoms_multiple: int = 8,
    neighbors_multiple: int = 8,
    use_ring: bool = False,
    feature: str = "atomic",
    canonical_frame: bool = False,
) -> Dict[str, np.ndarray]:
    """Featurize one structure into a padded model-input dict (batch of 1).

    The weight channel is the raw solid angle when ``angle`` (SCANN+), the
    max-normalized one otherwise. ``use_ring`` adds the [ring, aromatic]
    channel from the bond graph; ``feature="cgcnn"`` expands atomic numbers
    into the 92-dim CGCNN descriptors; ``canonical_frame`` rotates molecules
    into their principal-axes frame first.
    """
    if canonical_frame:
        struct = struct.canonicalized()
    neighbors = compute_voronoi_neighbors(
        struct.as_periodic(), cutoff=cutoff, d_thresh=d_t, w_thresh=w_t)
    n_atoms = len(struct)
    max_nbr = max((len(a) for a in neighbors), default=1)
    M = _round_up(n_atoms, atoms_multiple)
    N = _round_up(max(max_nbr, 1), neighbors_multiple)

    inputs = {
        "atomic": np.zeros((1, M), np.int32),
        "atom_mask": np.zeros((1, M, 1), np.float32),
        "neighbors": np.zeros((1, M, N), np.int32),
        "neighbor_mask": np.zeros((1, M, N), np.float32),
        "neighbor_weight": np.zeros((1, M, N), np.float32),
        "neighbor_distance": np.zeros((1, M, N), np.float32),
    }
    inputs["atomic"][0, :n_atoms] = struct.atomic_numbers
    inputs["atom_mask"][0, :n_atoms, 0] = 1.0
    w_col = 2 if angle else 3
    for a, lst in enumerate(neighbors):
        for j, rec in enumerate(lst):
            inputs["neighbors"][0, a, j] = int(rec[1])
            inputs["neighbor_mask"][0, a, j] = 1.0
            inputs["neighbor_weight"][0, a, j] = float(rec[w_col])
            inputs["neighbor_distance"][0, a, j] = float(rec[-1])

    if use_ring:
        from scann_tpu_torch.data.bonds import ring_aromatic_flags

        ring, aromatic = ring_aromatic_flags(list(struct.species), struct.coords)
        ra = np.zeros((1, M, 2), np.float32)
        ra[0, :n_atoms, 0] = ring
        ra[0, :n_atoms, 1] = aromatic
        inputs["ring_aromatic"] = ra

    if feature == "cgcnn":
        from scann_tpu_torch.data.atomic_data import get_atomic_features

        table = get_atomic_features()
        feat = np.zeros((1, M, 92), np.float32)
        for a, z in enumerate(struct.atomic_numbers):
            feat[0, a] = table[str(int(z))]
        inputs["atomic"] = feat
    return inputs


class Scann:
    """Train / eval / infer lifecycle for one config on one device, like
    the reference ``SCANN`` class."""

    def __init__(self, config: Union[ScannConfig, dict, str], pretrained: str = "",
                 device: Union[str, torch.device] = "cuda", workdir: Optional[str] = None,
                 mesh=None):
        if isinstance(config, str):
            config = load_config(config)
        elif isinstance(config, dict):
            config = ScannConfig.from_dict(config)
        self.config = config
        self.trainer = Trainer(config, resolve_device(device), workdir, mesh=mesh)
        self.device = self.trainer.device
        self.exec_cache = self.trainer.exec_cache
        self._buckets = None
        self.train_buckets = self.valid_buckets = self.test_buckets = None
        self._feat_pool = None
        self._feat_pool_lock = threading.Lock()
        if pretrained:
            self.load_pretrained(pretrained)
            self.config.hyper.pretrained = pretrained

    # --- parameters -----------------------------------------------------------

    @property
    def params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The trainer's parameters (flat dict keyed like the flax tree)."""
        return self.trainer.params

    def load_params(self, params) -> Dict[str, torch.Tensor]:
        """Install a flax-layout parameter tree (``{"params": ...}`` or
        bare, numpy arrays): from the JAX package or ``load_h5_params``.
        Every key and shape is checked against the config."""
        return self.trainer.load_params(params_from_jax(params, self.config.model))

    def init_params(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Random parameters with the Keras initializers, from ``seed``."""
        return self.trainer.init_state(seed)

    @classmethod
    def load_model_infer(cls, workdir: str, device: Union[str, torch.device] = "cuda"
                         ) -> "Scann":
        """An inference-ready model from a training run directory: the config
        and weights of its ``checkpoints/best.pt`` (reference
        ``SCANN.load_model_infer``, ``scann_model.py:85-91``). Needs no yaml."""
        path = os.path.join(workdir, "checkpoints", "best.pt")
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        obj = cls(ScannConfig.from_dict(ckpt["config"]), device=device, workdir=workdir)
        obj.trainer.restore_checkpoint("best")
        return obj

    def load_pretrained(self, path: str, with_optimizer: bool = False):
        """Load one of three things (JAX ``Scann.load_pretrained``):

        - a reference Keras H5 file (``.h5``/``.hdf5``, full-model or
          weights-only): its weights and, with ``with_optimizer``, the Adam
          slots and iteration counter of a full-model H5, so a reference run
          moves over mid-flight (``load_h5_optimizer``);
        - a checkpoint of this package: ``<run>/checkpoints/<name>[.pt]``
          restores that name, a run directory its ``best``. Like the JAX
          package's own checkpoints it brings back parameters, Adam state
          and step, and the run directory becomes the trainer's workdir;
        - anything else raises. The port cannot read an orbax directory of
          the JAX package (orbax imports JAX): restore it with ``scann_tpu``
          and install its parameters with ``load_params``.
        """
        if path.endswith((".h5", ".hdf5")):
            from scann_tpu_torch.compat.h5_loader import load_h5_optimizer, load_h5_params

            self.load_params(load_h5_params(path, self.config.model))
            if with_optimizer:
                self.trainer.load_optimizer(*load_h5_optimizer(path, self.config.model))
            return self.params
        found = _port_checkpoint(path)
        if found is None:
            raise ValueError(
                f"{path}: not a Keras H5 file nor a checkpoint of this package "
                "(<run>/checkpoints/<name>.pt or a run directory holding "
                "checkpoints/best.pt). An orbax checkpoint directory of the JAX package "
                "cannot be read here: restore it with scann_tpu (Scann.load_pretrained or "
                "Trainer.restore_checkpoint), then install its parameters with "
                "Scann.load_params(jax.device_get(trainer.state.params))")
        self.trainer.workdir, name = found
        self.trainer.restore_checkpoint(name)
        return self.params

    def export_h5(self, path: str) -> str:
        """Write the current parameters as a reference-layout Keras H5
        (``model_weights`` groups, the reference's layer and variable names:
        ``compat.save_h5_weights``), so a model trained here can be handed
        to tooling keyed on the published H5 format (reference
        ``scann_model.py:165-177``). Needs h5py."""
        self._require_state("export_h5")
        from scann_tpu_torch.compat.from_jax import params_to_flax
        from scann_tpu_torch.compat.h5_loader import save_h5_weights

        save_h5_weights(params_to_flax(self.params, self.config.model), self.config.model, path)
        return path

    def enable_exec_cache(self, cache_dir: Optional[str] = None) -> Optional[str]:
        """Build the kernels into, and load them from, ``cache_dir`` (default
        ``{workdir}/exec_cache``: for a model from ``load_model_infer`` the
        served run directory), for the whole process, so a later process
        with the same directory, sources and toolchain starts without nvcc
        (``utils/exec_cache.py``). Returns the directory; one that cannot be
        created warns and returns None, and the kernels build where they
        did: the cache is a speedup, never a condition of serving."""
        cache_dir = cache_dir or os.path.join(self.trainer.workdir, "exec_cache")
        from scann_tpu_torch.kernels import _build

        try:
            self.exec_cache = _build.set_build_dir(cache_dir)
        except OSError as e:
            import warnings

            warnings.warn(f"exec cache disabled: cannot create {cache_dir!r} ({e}); the "
                          "kernels build where they did without the cache")
            return None
        return self.exec_cache.cache_dir

    def _require_state(self, what: str):
        if self.params is None:
            raise RuntimeError(
                f"{what} needs parameters, but none are loaded: pass "
                "pretrained= to Scann(), or call load_params / load_pretrained")

    # --- forward --------------------------------------------------------------

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return _to_device(batch, self.device)

    def forward_eval(self, params: Dict[str, torch.Tensor], batch
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Deterministic forward -> (property [B, 1], ga_score [B, M, 1]).

        On CUDA the batch's (M, N) picks the route before anything is
        launched (``Trainer.eval_route``): the whole-model molecule kernel
        (M <= 64), else the whole-model crystal loop kernel, both on the
        kernel layout of the weights that ``Trainer.kernel_params`` keeps
        for the current parameter version, else the per-layer model with
        one LocalAttention kernel launch per layer. On the CPU it runs the
        eager model. The batch's index ranges are checked here, once: a
        batch of numpy arrays on the host before the copy, so the launch
        reads nothing back; a batch of tensors with one read-back."""
        check_index_ranges(batch, self.config.model)
        return self.trainer.forward_eval(params, self._to_device(batch))

    # --- dataset and training -------------------------------------------------

    def prepare_dataset(self, split: bool = True):
        """Load the configured dataset pair, standardize the target
        (``hyper.scaler``), pad it into (M, N) buckets and, with ``split``,
        carve train / valid / test out of them (returns their indices);
        without, returns the buckets of the whole dataset.

        With ``tpu.structure_packing`` each split is one ``PackedSlots`` of
        several structures per slot (``data/packing.py``) instead, as
        ``scann_tpu/api.py:282-351`` packs them: capacity, neighbour width
        and segment count come from the whole dataset's CSR, so every split
        has one (M, N, S) shape; ``tpu.packing_capacity`` overrides the
        capacity (at least the largest structure, rounded up to
        ``tpu.atoms_pad_multiple``) and ``tpu.pack_max_segments`` is S."""
        hyper, cfm = self.config.hyper, self.config.model
        records, neighbors = load_dataset(hyper.data_energy_path, hyper.data_nei_path,
                                          hyper.target, use_ref=hyper.use_ref,
                                          use_ring=cfm.use_ring)
        if cfm.feature == "atomic":
            zmax = max(int(max(r["atomic"])) for r in records)
            if zmax >= cfm.n_atoms:
                raise ValueError(
                    f"dataset contains atomic number {zmax} but the model's embedding vocab "
                    f"is n_atoms={cfm.n_atoms}; raise model.n_atoms or use feature='cgcnn'")
        if hyper.scaler:
            ys = np.array([r["target"] for r in records], np.float64)
            mean, std = float(ys.mean()), float(ys.std())
            print(f"Standardizing target: mean {mean:.6f}, std {std:.6f}")
            for r in records:
                r["target"] = (r["target"] - mean) / std
            hyper.target_mean, hyper.target_std = mean, std
        hyper.data_size = len(records)
        if self.config.tpu.structure_packing:
            return self._prepare_packed(records, neighbors, split)
        buckets = pack_dataset(
            records, neighbors, g_update=cfm.g_update, feature=cfm.feature,
            use_ring=cfm.use_ring, atoms_multiple=self.config.tpu.atoms_pad_multiple,
            neighbors_multiple=self.config.tpu.neighbors_pad_multiple,
            max_buckets=self.config.tpu.max_buckets,
            csr_cache_path=hyper.data_nei_path + ".csr.npz", csr_source_path=hyper.data_nei_path)
        if not split:
            self._buckets = buckets
            return buckets
        tr, va, te = split_data(len(records), test_percent=hyper.test_percent,
                                train_size=hyper.train_size, test_size=hyper.test_size,
                                seed=hyper.seed)
        print(f"Split: {len(tr)} train / {len(va)} valid / {len(te)} test")
        self.train_buckets = subset_buckets(buckets, tr)
        self.valid_buckets = subset_buckets(buckets, va)
        self.test_buckets = subset_buckets(buckets, te)
        return tr, va, te

    def _prepare_packed(self, records, neighbors, split: bool):
        """The packed branch of ``prepare_dataset``."""
        hyper, cfm, tpu = self.config.hyper, self.config.model, self.config.tpu
        csr = build_csr(records, neighbors, hyper.data_nei_path + ".csr.npz",
                        source_path=hyper.data_nei_path)
        max_atoms = int(np.diff(csr.atom_offsets).max())
        capacity = _round_up(max_atoms, tpu.atoms_pad_multiple)
        if tpu.packing_capacity is not None:
            if tpu.packing_capacity < max_atoms:
                raise ValueError(f"tpu.packing_capacity={tpu.packing_capacity} is below the "
                                 f"dataset's largest structure ({max_atoms} atoms)")
            capacity = _round_up(int(tpu.packing_capacity), tpu.atoms_pad_multiple)
        n_cap = _round_up(max(int(np.diff(csr.nbr_offsets).max()), 1),
                          tpu.neighbors_pad_multiple)

        def pack(sub, name):
            sub = np.asarray(sub, np.int64)
            p = pack_dataset_slots(
                [records[i] for i in sub], [neighbors[i] for i in sub], csr=csr.subset(sub),
                g_update=cfm.g_update, feature=cfm.feature, use_ring=cfm.use_ring,
                atoms_multiple=tpu.atoms_pad_multiple,
                neighbors_multiple=tpu.neighbors_pad_multiple, capacity=capacity,
                max_segments=tpu.pack_max_segments, orig_indices=sub,
                neighbors_capacity=n_cap, segments_capacity=tpu.pack_max_segments)
            print(f"Packed {name} split: {p.num_structures} structures in {p.num_slots} "
                  f"slots of {capacity} rows ({p.occupancy:.1%} occupancy, "
                  f"<= {p.num_segments} segments/slot)")
            return [p]

        if not split:
            self._buckets = pack(np.arange(len(records)), "full")
            return self._buckets
        tr, va, te = split_data(len(records), test_percent=hyper.test_percent,
                                train_size=hyper.train_size, test_size=hyper.test_size,
                                seed=hyper.seed)
        print(f"Split: {len(tr)} train / {len(va)} valid / {len(te)} test")
        self.train_buckets = pack(tr, "train")
        self.valid_buckets = pack(va, "valid")
        self.test_buckets = pack(te, "test")
        return tr, va, te

    def train(self, epochs: Optional[int] = None, resume: bool = False):
        if self.train_buckets is None:
            raise RuntimeError("no training data: call prepare_dataset() first")
        return self.trainer.fit(self.train_buckets, self.valid_buckets, epochs=epochs,
                                resume=resume)

    def evaluate(self):
        """Test-set report. After training in this session it evaluates the
        best-val checkpoint (reference ``scann_model.py:249-258``); with
        loaded weights it keeps them; otherwise it loads the run's best."""
        best = self.trainer._checkpoint_path("best")
        if self.trainer.history is not None and os.path.exists(best):
            self.trainer.restore_checkpoint("best")
        elif self.params is None:
            if not os.path.exists(best):
                raise RuntimeError(f"no parameters to evaluate: no checkpoint at {best}; "
                                   "train first or pass pretrained=")
            self.trainer.restore_checkpoint("best")
        buckets = self._buckets if self._buckets is not None else self.test_buckets
        if buckets is None:
            raise RuntimeError("no data to evaluate: call prepare_dataset() first")
        result = self.trainer.evaluate(buckets)
        print(f"Test {self.config.hyper.target}: "
              f"MAE {result['test_mae']:.6f}, R2 {result['test_r2']:.5f}")
        return result

    def predict_data(self, buckets=None, with_ga: bool = False):
        """Predict over buckets (or packed slots), un-standardized, in dataset
        order; defaults to the whole prepared dataset."""
        if buckets is None:
            if self._buckets is not None:
                buckets = self._buckets
            elif self.train_buckets is not None:
                buckets = (list(self.train_buckets) + list(self.valid_buckets)
                           + list(self.test_buckets))
            else:
                raise RuntimeError("no data: call prepare_dataset() or pass buckets")
        self._require_state("predict_data")
        return self.trainer.predict(buckets, with_ga=with_ga)

    # --- structures -----------------------------------------------------------

    def _check_vocab(self, structs: List[Structure]):
        """Atomic numbers outside the embedding vocab would index past the
        table: raise with the offending elements instead."""
        if self.config.model.feature != "atomic":
            return
        vocab = self.config.model.n_atoms
        for s in structs:
            bad = [sp for sp, z in zip(s.species, s.atomic_numbers) if int(z) >= vocab]
            if bad:
                raise ValueError(
                    f"structure contains element(s) {sorted(set(bad))} with atomic "
                    f"number >= the model's embedding vocab (model.n_atoms={vocab}); "
                    "retrain with a larger n_atoms or use feature='cgcnn'")

    @staticmethod
    def _as_structure(struct: StructureLike) -> Structure:
        if isinstance(struct, (str, os.PathLike)):
            return Structure.from_file(os.fspath(struct))
        return struct

    def _featurize_executor(self, n: int):
        """Persistent spawn-context featurization pool, created lazily and
        replaced when its workers died."""
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with self._feat_pool_lock:
            ex = self._feat_pool
            if ex is not None and getattr(ex, "_broken", False):
                ex.shutdown(wait=False)
                ex = self._feat_pool = None
            if ex is None:
                ex = self._feat_pool = ProcessPoolExecutor(
                    n, mp_context=mp.get_context("spawn"))
            return ex

    def close(self):
        """Release the featurization pool."""
        with self._feat_pool_lock:
            if self._feat_pool is not None:
                self._feat_pool.shutdown(wait=True)
                self._feat_pool = None

    def predict_structure(self, struct: StructureLike, d_t: float = 4.0,
                          w_t: float = 0.4, canonical_frame: bool = True
                          ) -> Tuple[float, np.ndarray]:
        """(value, per-atom GA scores) for one structure or file path."""
        return self.predict_structures([struct], d_t=d_t, w_t=w_t,
                                       canonical_frame=canonical_frame)[0]

    def predict_structures(self, structs: List[StructureLike], d_t: float = 4.0,
                           w_t: float = 0.4, featurize_pool: int = 0,
                           batch_size: Optional[int] = None,
                           canonical_frame: bool = True
                           ) -> List[Tuple[float, np.ndarray]]:
        """Batched inference over many structures (the serving path);
        returns [(value, ga_scores)] in input order."""
        structs, all_inputs = self.featurize_structures(
            structs, d_t=d_t, w_t=w_t, featurize_pool=featurize_pool,
            canonical_frame=canonical_frame)
        return self.predict_featurized(structs, all_inputs, batch_size=batch_size)

    def featurize_structures(self, structs: List[StructureLike], d_t: float = 4.0,
                             w_t: float = 0.4, featurize_pool: int = 0,
                             canonical_frame: bool = True):
        """Stage 1 of the serving path: host featurization only. Returns
        ``(structs, all_inputs)`` for ``predict_featurized``."""
        self._require_state("featurize_structures")
        structs = [self._as_structure(s) for s in structs]
        self._check_vocab(structs)
        if canonical_frame:
            _canonical_frame_notice(structs)
        cfm = self.config.model
        kw = dict(d_t=d_t, w_t=w_t, angle=cfm.g_update, use_ring=cfm.use_ring,
                  feature=cfm.feature, canonical_frame=canonical_frame)
        if featurize_pool > 1:
            from concurrent.futures.process import BrokenProcessPool
            from functools import partial

            if native_voronoi_enabled():
                native_voronoi.get_lib()    # built here, so the workers only load it

            try:
                ex = self._featurize_executor(featurize_pool)
                all_inputs = list(ex.map(partial(prepare_input, **kw), structs,
                                         chunksize=4))
            except BrokenProcessPool:
                # a worker died: rebuild the pool once and retry
                ex = self._featurize_executor(featurize_pool)
                all_inputs = list(ex.map(partial(prepare_input, **kw), structs,
                                         chunksize=4))
        else:
            all_inputs = [prepare_input(s, **kw) for s in structs]
        return structs, all_inputs

    def predict_featurized(self, structs: List[Structure], all_inputs,
                           batch_size: Optional[int] = None
                           ) -> List[Tuple[float, np.ndarray]]:
        """Stage 2 of the serving path: group by ladder-quantized (M, N),
        pad, run each group in batches of at most ``batch_size`` (its last
        batch at the group's own remainder: the kernels take any B, so a
        lone structure launches at B=1), un-standardize."""
        self._require_state("predict_featurized")
        base_m = self.config.tpu.atoms_pad_multiple
        base_n = self.config.tpu.neighbors_pad_multiple
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, inp in enumerate(all_inputs):
            key = (_ladder(inp["atomic"].shape[1], base_m),
                   _ladder(inp["neighbors"].shape[2], base_n))
            groups.setdefault(key, []).append(i)

        def repad(inp, M, N):
            out = {}
            for k, v in inp.items():
                pad = [(0, 0)] * v.ndim
                pad[1] = (0, M - v.shape[1])
                if v.ndim == 3 and k not in ("atom_mask", "ring_aromatic", "atomic"):
                    pad[2] = (0, N - v.shape[2])  # neighbor tensors [1, M, N]
                out[k] = np.pad(v, pad)
            return out

        bs = batch_size or self.config.hyper.batch_size
        hyper = self.config.hyper
        results: List[Optional[Tuple[float, np.ndarray]]] = [None] * len(structs)
        for (M, N), members in groups.items():
            padded = {i: repad(all_inputs[i], M, N) for i in members}
            G = len(members)
            for s0 in range(0, G, bs):
                idxs = members[s0:s0 + bs]
                batch = {k: np.concatenate([padded[i][k] for i in idxs])
                         for k in padded[members[0]]}
                pred, ga = self.forward_eval(self.params, batch)
                pred = pred[:, 0].cpu().numpy() * hyper.target_std + hyper.target_mean
                ga = ga[..., 0].cpu().numpy()
                for row, i in enumerate(idxs):
                    results[i] = (float(pred[row]), ga[row, : len(structs[i])])
        return results

    def _example_inputs(self, M: int = 8, N: int = 4, B: int = 1) -> Dict[str, np.ndarray]:
        ex = {
            "atomic": np.zeros((B, M), np.int32),
            "atom_mask": np.ones((B, M, 1), np.float32),
            "neighbors": np.zeros((B, M, N), np.int32),
            "neighbor_mask": np.ones((B, M, N), np.float32),
            "neighbor_weight": np.ones((B, M, N), np.float32),
            "neighbor_distance": np.ones((B, M, N), np.float32),
        }
        if self.config.model.feature == "cgcnn":
            ex["atomic"] = np.zeros((B, M, 92), np.float32)
        if self.config.model.use_ring:
            ex["ring_aromatic"] = np.zeros((B, M, 2), np.float32)
        return ex

    def warmup_serving(self, shapes: List[Tuple[int, int]],
                       batch_size: int = 1) -> List[Tuple[int, int]]:
        """Run each distinct ladder rung of the (max_atoms, max_neighbors)
        shapes once on dummy inputs of ``batch_size`` structures, so the
        first requests do not pay the build or the first launch of the
        kernel that rung takes. On CUDA every kernel is built (or loaded
        from the build cache) first, one nvcc each, all at once: the narrow
        builds, and the wide or tall builds that a rung's route takes. Served
        batches come at any size, so one structure does. Returns the rungs
        run."""
        self._require_state("warmup_serving")
        base_m = self.config.tpu.atoms_pad_multiple
        base_n = self.config.tpu.neighbors_pad_multiple
        if self.device.type == "cuda":
            from scann_tpu_torch.kernels import _build

            rungs = {(_ladder(int(m), base_m), _ladder(int(n), base_n), 0) for m, n in shapes}
            _build.build_all(_build.SOURCES + self.trainer.shape_libraries(sorted(rungs)))
        done: List[Tuple[int, int]] = []
        for m, n in shapes:
            rung = (_ladder(int(m), base_m), _ladder(int(n), base_n))
            if rung in done:
                continue
            pred, _ = self.forward_eval(self.params,
                                        self._example_inputs(M=rung[0], N=rung[1], B=batch_size))
            pred.cpu()
            done.append(rung)
        return done
