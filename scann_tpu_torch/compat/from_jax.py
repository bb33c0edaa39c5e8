"""Carry a flax-layout parameter tree across to the port's flat tensor dict,
and back (``params_to_flax``, for the H5 export).

The tree may come from the JAX package (``trainer.state.params``, moved to
the host as numpy) or from ``compat.h5_loader.load_h5_params``; both are
nested dicts ``{"embed_atom": {"embedding": ...}, "local_attention_0":
{"filter_geo": {"kernel": ...}}, ...}``, optionally under a ``"params"``
root. Every leaf is checked against the model's ``param_shapes`` for the
config: a missing, extra or mis-shaped leaf raises.
"""

from typing import Dict

import numpy as np
import torch

from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.models.scann import param_shapes


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            _flatten(v, key, out)
        else:
            out[key] = np.asarray(v)


def params_from_jax(tree, config: ModelConfig,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """flax params (``{"params": ...}`` or bare) -> ``{"a/b/kernel": f32
    tensor on device}``."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    want = param_shapes(config)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(
            f"parameter tree does not match the config: missing {missing}, "
            f"unexpected {extra}")
    bad = {k: (tuple(flat[k].shape), want[k]) for k in want
           if tuple(flat[k].shape) != want[k]}
    if bad:
        raise ValueError(f"parameter shapes do not match the config "
                         f"(got, expected): {bad}")
    return {k: torch.from_numpy(np.array(flat[k], np.float32)).to(device)
            for k in want}


def params_to_flax(params: Dict[str, torch.Tensor], config: ModelConfig) -> dict:
    """The inverse of ``params_from_jax``: the port's flat dict
    ``{"a/b/kernel": tensor}`` -> the nested flax tree of f32 numpy arrays
    (bare, without a ``"params"`` root). Keys and shapes are checked
    against the config as ``params_from_jax`` checks them."""
    want = param_shapes(config)
    if set(params) != set(want):
        raise ValueError(f"parameter keys do not match the config: "
                         f"{sorted(set(params) ^ set(want))}")
    tree: dict = {}
    for key in want:
        arr = params[key].detach().cpu().numpy().astype(np.float32)
        if tuple(arr.shape) != want[key]:
            raise ValueError(f"parameter {key}: shape {tuple(arr.shape)}, expected {want[key]}")
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree
