"""Materials Project 2018.6.1 dataset builder (periodic crystals; port of
``scann_tpu/data/builders/mp2018.py``).

Same source archive as the reference (``mp2018.py:22``): a zip containing
``mp.2018.6.1.json`` with CIF strings + formation energy / band gap per
material. Structures with a single atom are skipped (reference
``mp2018.py:40``: ``len(mol) > 1``). Output schema: fractional coords +
lattice, ``Cartesian: False`` (``mp2018.py:48-57``).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile

import numpy as np

from scann_tpu_torch.data.atomic_data import atomic_numbers
from scann_tpu_torch.data.cif import parse_cif
from scann_tpu_torch.data.builders.common import download, save_dataset

MP2018_URL = "https://ndownloader.figshare.com/files/15087992"


def record_from_entry(entry: dict, idx=None):
    """One MP json entry -> dataset record (or None for 1-atom cells)."""
    struct = parse_cif(entry["structure"])
    if len(struct) <= 1:
        return None
    return {
        "id": entry.get("material_id", idx),
        "Properties": {
            "e_f": entry["formation_energy_per_atom"],
            "e_b": entry["band_gap"],
        },
        "Atoms": list(struct.species),
        "Atomic": [atomic_numbers[s] for s in struct.species],
        "Coords": struct.frac_coords,
        "Lattice": struct.lattice,
        "Cartesian": False,
    }


def process_mp2018(save_path: str = ""):
    tmpdir = tempfile.mkdtemp("mp2018")
    try:
        zip_path = download(MP2018_URL, os.path.join(tmpdir, "mp.2018.6.1.zip"),
                            "MP2018.6.1")
        data = json.loads(zipfile.ZipFile(zip_path).read("mp.2018.6.1.json"))
        records = []
        for idx, entry in enumerate(data):
            if idx % 10000 == 0:
                print(f"  parsing {idx}/{len(data)}")
            rec = record_from_entry(entry, idx)
            if rec is not None:
                records.append(rec)
        return save_dataset(records, save_path, "mp2018")
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
