"""Shared builder utilities: downloads, record schema, saving (port of
``scann_tpu/data/builders/common.py``)."""

from __future__ import annotations

import os
import urllib.error
import urllib.request
from typing import List

import numpy as np

# energy unit conversion (CODATA 2018), matching ase.units.Hartree
HARTREE_TO_EV = 27.211386245988


def download(url: str, dest: str, what: str = "dataset") -> str:
    """urlretrieve with a clear failure message for no-egress environments."""
    print(f"Downloading {what}: {url}")
    try:
        urllib.request.urlretrieve(url, dest)
    except (urllib.error.URLError, OSError) as e:
        raise RuntimeError(
            f"download of {what} failed ({e}). This environment may have no "
            f"network egress; fetch {url} manually and place it at {dest}, "
            "or use the 'synthetic' dataset for offline runs."
        ) from e
    return dest


def save_dataset(records: List[dict], save_path: str, dataset: str,
                 sort_by_size: bool = True) -> str:
    """Save records as the ``{ds}_data_energy.npy`` object array, sorted by
    atom count (the reference's implicit length bucketing, ``qm9.py:160``)."""
    ds_dir = os.path.join(save_path, dataset)
    os.makedirs(ds_dir, exist_ok=True)
    if sort_by_size:
        records = sorted(records, key=lambda r: len(r["Atoms"]))
    out = os.path.join(ds_dir, f"{dataset}_data_energy.npy")
    np.save(out, np.asarray(records, dtype=object))
    print(f"saved {len(records)} structures -> {out}")
    return out
