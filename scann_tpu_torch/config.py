"""Configuration system (the port's own copy of ``scann_tpu/config.py``).

YAML-compatible with the repo's ``configs/*.yaml``: blocks ``model:`` /
``hyper:`` / ``tpu:``, with the same keys and defaults as the JAX package,
so one config file drives both. ``yaml`` is imported only inside
``load_config``; ``save_config`` writes the mapping by hand, so training
and checkpoints need no yaml.
The ``tpu:`` block is kept for file compatibility; the port reads only its
padding multiples (``atoms_pad_multiple``, ``neighbors_pad_multiple``).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Optional


# Reference ``use_drop``: Dropout(0.05) on the post-softmax attention
# probabilities, training only (reference attention.py:115-116,191-192).
# Single source of truth for every kernel family and the flax model.
ATTN_DROPOUT_RATE = 0.05


def attn_dropout_rate(model_cfg, dropout_rate: float) -> float:
    """Attention-dropout rate active for a step (0 at eval / use_drop off)."""
    return (ATTN_DROPOUT_RATE
            if (model_cfg.use_drop and dropout_rate > 0.0) else 0.0)


def _noneify(v):
    """Reference YAMLs use "" for unset sizes (e.g. train_size: "")."""
    if v == "" or v is None:
        return None
    return v


@dataclass
class ModelConfig:
    """Mirrors the ``model:`` block (reference scann_model.py:330, configs/*.yaml)."""

    n_atoms: int = 10              # embedding vocabulary (max atomic number + 1)
    embedding_dim: int = 48
    n_attention: int = 7
    local_dim: int = 128
    num_head: int = 8
    global_dim: int = 128
    dense_out: int = 128
    scale: float = 0.5             # attention exponent: dk = hdim ** -scale
    use_attn_norm: bool = True     # ResidualNorm after each LocalAttention
    use_ga_norm: bool = True       # L2-normalize GA scores over atoms
    use_ring: bool = False         # extra [ring, aromatic] channel (molecules)
    g_update: bool = True          # SCANN+ self-consistent geometry update
    gaussian_d: float = 4.0        # distance RBF range: linspace(0, gaussian_d, 20)
    feature: str = "atomic"        # "atomic" (embedding) | "cgcnn" (92-dim one-hot)
    use_drop: bool = False         # attention dropout 0.05

    # --- TPU extensions (not in reference) ---
    num_gaussian: int = 20         # RBF basis size (reference hardcodes 20)
    dtype: str = "float32"         # compute dtype: "float32" | "bfloat16"


@dataclass
class HyperConfig:
    """Mirrors the ``hyper:`` block."""

    batch_size: int = 32
    test_percent: float = 0.1
    train_size: Optional[int] = None
    test_size: Optional[int] = None
    data_size: Optional[int] = None
    scaler: bool = True            # standardize target with train mean/std
    scheduler: str = "cosine"      # "cosine" | "sgdr"
    lr: float = 5e-4
    min_lr: float = 1e-4
    use_ref: bool = False          # subtract Ref_energy from target
    target: str = "homo"
    data_energy_path: str = ""
    data_nei_path: str = ""
    save_path: str = "trained_models/scann_tpu"
    pretrained: str = ""
    # learned at prepare_dataset time, re-serialized for self-contained inference
    # (reference scann_model.py:113-116)
    target_mean: float = 0.0
    target_std: float = 1.0

    # --- TPU extensions ---
    epochs: int = 1000
    patience: int = 200            # early stopping on val MAE (reference: 200)
    l2_reg: float = 1e-4           # Keras kernel_regularizer l2 coefficient
    adam_decay: float = 1e-5       # Keras Adam(decay=) inverse-time lr decay
    seed: int = 0


@dataclass
class TpuConfig:
    """TPU-specific knobs with no reference counterpart."""

    use_pallas: bool = True        # fused Pallas attention kernels on TPU
    data_parallel: bool = True     # shard batch over the 'data' mesh axis
    mesh_shape: Optional[list] = None   # e.g. [8] -> Mesh(('data',), 8)
    atoms_pad_multiple: int = 8    # pad M (atom axis) to a multiple
    # pad N (neighbor axis) to a multiple of 8: N is the SUBLANE dim of
    # every [M, N, D] tensor in the Pallas kernels (f32 tile = (8, 128));
    # a non-multiple (e.g. 12) forces masked sublane handling in every
    # rank-3 op and was observed to blow Mosaic compile time/memory up
    # (37-minute compile, then compile-helper OOM) on unrolled kernels
    neighbors_pad_multiple: int = 8
    max_buckets: int = 4           # static-shape (M, N) bucket count
    device_resident_data: bool = True  # keep the whole padded dataset in HBM
    donate_state: bool = True
    # STRUCTURE PACKING (data/packing.py): bin-pack several structures per
    # padded (M, N) slot, with per-structure math equal to the unpacked path
    # (segment-aware GA readout). All three splits pack; eval and predict
    # are segment-aware end to end.
    structure_packing: bool = False
    pack_max_segments: int = 8     # max structures per packed slot (S)
    # Slot capacity (rows) override for structure packing. None (default)
    # derives it from the dataset's max structure size rounded to
    # atoms_pad_multiple (QM9: 29 -> 32); a larger capacity packs denser.
    # Must be >= the largest structure; values below it raise at
    # prepare_dataset.
    packing_capacity: Optional[int] = None
    # Preserve the reference recipe's EFFECTIVE batch: hyper.batch_size
    # counts STRUCTURES, so the Trainer batches round(batch_size / packing
    # factor) slots per step (~batch_size structures each). Disable to
    # batch hyper.batch_size slots instead (bigger effective batches).
    pack_preserve_batch: bool = True
    # Persist compiled train/eval/predict executables under this dir so
    # re-runs of the same config+shapes (restarts, resumes, eval-only,
    # fleet fan-out) skip XLA/Pallas compiles entirely — the crystal loop
    # kernels compile for minutes, and the remote Mosaic compile bypasses
    # JAX's own persistent cache. Keyed by config + schedule + argument
    # avals + (jax version, backend, device kind/count); loads are
    # validated on dummies and fall back to plain compiles on any
    # failure (utils/exec_cache.py). None = off.
    exec_cache_dir: Optional[str] = None
    # Padded (M, N) bucket shapes of the data this model was trained on,
    # recorded by Trainer.fit into the run dir's config.yaml. Serving warms
    # (pre-compiles) these rungs by default so first requests don't pay XLA
    # compile stalls (~45 s/shape over a remote TPU); see cli/serve.py.
    observed_buckets: Optional[list] = None


@dataclass
class ScannConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    hyper: HyperConfig = field(default_factory=HyperConfig)
    tpu: TpuConfig = field(default_factory=TpuConfig)

    @classmethod
    def from_dict(cls, d: dict) -> "ScannConfig":
        def fill(dc_cls, block: dict, block_name: str):
            names = {f.name for f in dataclasses.fields(dc_cls)}
            kwargs = {}
            for k, v in (block or {}).items():
                if k not in names:
                    # a typo'd hyperparameter silently training on the
                    # default is worse than noise: warn, don't drop quietly
                    import warnings

                    warnings.warn(
                        f"config: unknown key '{block_name}.{k}' ignored "
                        f"(value {v!r}); check for typos", stacklevel=3)
                    continue
                if k in ("train_size", "test_size", "data_size"):
                    v = _noneify(v)
                if k in ("target_mean", "target_std") and v is not None:
                    v = float(v)
                kwargs[k] = v
            return dc_cls(**kwargs)

        return cls(
            model=fill(ModelConfig, d.get("model", {}), "model"),
            hyper=fill(HyperConfig, d.get("hyper", {}), "hyper"),
            tpu=fill(TpuConfig, d.get("tpu", {}), "tpu"),
        )

    def to_dict(self) -> dict:
        return {
            "model": dataclasses.asdict(self.model),
            "hyper": dataclasses.asdict(self.hyper),
            "tpu": dataclasses.asdict(self.tpu),
        }

    def replace(self, **blocks: Any) -> "ScannConfig":
        return dataclasses.replace(self, **blocks)


def load_config(path: str) -> ScannConfig:
    import yaml

    with open(path) as f:
        return ScannConfig.from_dict(yaml.safe_load(f))


def _yaml_scalar(v) -> str:
    """One value in YAML 1.1 syntax that ``yaml.safe_load`` reads back as
    the same Python value: JSON-quoted strings and flow lists, floats with
    a decimal point (``1e-05`` alone would load as a string)."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "e" in text and "." not in text.split("e")[0]:
            mant, exp = text.split("e")
            text = f"{mant}.0e{exp}"
        return text
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_scalar(x) for x in v) + "]"
    return json.dumps(str(v))


def save_config(config: ScannConfig, path: str) -> None:
    """Write the config as the two-level YAML mapping ``load_config``
    reads, by hand: it needs no ``yaml`` module."""
    lines = []
    for block, values in config.to_dict().items():
        lines.append(f"{block}:")
        lines.extend(f"  {k}: {_yaml_scalar(v)}" for k, v in values.items())
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
