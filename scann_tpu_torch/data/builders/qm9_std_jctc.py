"""QM9-std-JCTC dataset builder (the standardized JCTC re-release; port of
``scann_tpu/data/builders/qm9_std_jctc.py``).

Same figshare source as the reference (``qm9_std_jctc.py:26``): a zip with
``qm9_std_jctc.json``; each entry carries elements + fractional coords +
lattice and the 13 target properties. Ring/aromatic flags derived from the
bond graph (see ``data/bonds.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile

import numpy as np

from scann_tpu_torch.data.atomic_data import atomic_numbers
from scann_tpu_torch.data.bonds import ring_aromatic_flags
from scann_tpu_torch.data.builders.common import download, save_dataset

QM9_STD_URL = "https://ndownloader.figshare.com/files/28715319"

PROPERTY_KEYS = {
    "mu": "mu", "alpha": "alpha", "homo": "HOMO", "lumo": "LUMO",
    "gap": "gap", "r2": "R2", "zpve": "ZPVE", "U0": "U0", "U": "U",
    "H": "H", "Cv": "Cv", "G": "G", "omega1": "omega1",
}


def record_from_entry(entry: dict) -> dict:
    atoms = entry["atoms"]
    coords = np.dot(np.asarray(atoms["coords"], dtype=np.float64),
                    np.asarray(atoms["lattice_mat"], dtype=np.float64)).astype(np.float32)
    species = list(atoms["elements"])
    ring, aromatic = ring_aromatic_flags(species, coords)
    return {
        "id": entry["id"],
        "Properties": {ours: float(entry[theirs])
                       for ours, theirs in PROPERTY_KEYS.items()},
        "Atoms": species,
        "Atomic": [atomic_numbers[s] for s in species],
        "Coords": coords,
        "Cartesian": True,
        "Features": {"Ring": ring.tolist(), "Aromatic": aromatic.tolist()},
    }


def process_qm9_std_jctc(save_path: str = ""):
    tmpdir = tempfile.mkdtemp("qm9std")
    try:
        zip_path = download(QM9_STD_URL, os.path.join(tmpdir, "qm9_std_jctc.zip"),
                            "QM9-std-JCTC")
        data = json.loads(zipfile.ZipFile(zip_path).read("qm9_std_jctc.json"))
        records = []
        for idx, entry in enumerate(data):
            if idx % 10000 == 0:
                print(f"  parsing {idx}/{len(data)}")
            records.append(record_from_entry(entry))
        return save_dataset(records, save_path, "qm9_std_jctc")
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
