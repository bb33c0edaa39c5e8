"""QM9 (gdb9) dataset builder (port of ``scann_tpu/data/builders/qm9.py``).

Downloads the figshare gdb9 archive (same source as the reference,
``qm9.py:84``), removes the 3054 uncharacterized molecules, parses the QM9
xyz variant (properties on the comment line, ``*^`` exponent notation),
converts Hartree-valued properties to eV, and derives ring/aromatic flags
from the bond graph (OpenBabel-free; see ``data/bonds.py``).
Output schema matches the reference (``qm9.py:137-148``): sorted by atom
count, ``{id, Properties, Atoms, Atomic, Coords, Cartesian, Features}``.
"""

from __future__ import annotations

import os
import re
import shutil
import tarfile
import tempfile

import numpy as np

from scann_tpu_torch.data.atomic_data import atomic_numbers
from scann_tpu_torch.data.bonds import ring_aromatic_flags
from scann_tpu_torch.data.builders.common import HARTREE_TO_EV, download, save_dataset

GDB9_URL = "https://springernature.figshare.com/ndownloader/files/3195389"
UNCHARACTERIZED_URL = "https://springernature.figshare.com/ndownloader/files/3195404"

# QM9 property line: tag idx A B C mu alpha homo lumo gap r2 zpve U0 U H G Cv
PROPERTIES = [
    ("rcA", 1.0), ("rcB", 1.0), ("rcC", 1.0),
    ("mu", 1.0), ("alpha", 1.0),
    ("homo", HARTREE_TO_EV), ("lumo", HARTREE_TO_EV), ("gap", HARTREE_TO_EV),
    ("r2", 1.0), ("zpve", HARTREE_TO_EV),
    ("energy_U0", HARTREE_TO_EV), ("energy_U", HARTREE_TO_EV),
    ("enthalpy_H", HARTREE_TO_EV), ("free_G", HARTREE_TO_EV),
    ("Cv", 1.0),
]

EXPECTED_COUNT = 130831  # 133885 files - 3054 uncharacterized


def parse_qm9_xyz(text: str, idx=None) -> dict:
    """Parse one QM9-format xyz (text), returning the dataset record."""
    lines = text.replace("*^", "e").splitlines()
    n_atoms = int(lines[0].split()[0])
    prop_vals = lines[1].split()[2:]
    properties = {name: float(v) * conv
                  for (name, conv), v in zip(PROPERTIES, prop_vals)}

    species, coords = [], []
    for line in lines[2:2 + n_atoms]:
        parts = line.split()
        species.append(parts[0])
        coords.append([float(x) for x in parts[1:4]])
    coords = np.asarray(coords, dtype=np.float32)

    ring, aromatic = ring_aromatic_flags(species, coords)
    return {
        "id": idx,
        "Properties": properties,
        "Atoms": species,
        "Atomic": [atomic_numbers[s] for s in species],
        "Coords": coords,
        "Cartesian": True,
        "Features": {"Ring": ring.tolist(), "Aromatic": aromatic.tolist()},
    }


def _load_uncharacterized(tmpdir: str) -> np.ndarray:
    path = download(UNCHARACTERIZED_URL, os.path.join(tmpdir, "uncharacterized.txt"),
                    "QM9 uncharacterized-molecule list")
    ids = []
    with open(path) as f:
        for line in f.readlines()[9:-1]:
            ids.append(int(line.split()[0]))
    return np.asarray(ids)


def process_qm9(save_path: str = ""):
    tmpdir = tempfile.mkdtemp("gdb9")
    try:
        tar_path = download(GDB9_URL, os.path.join(tmpdir, "gdb9.tar.gz"), "QM9")
        raw = os.path.join(tmpdir, "xyz")
        with tarfile.open(tar_path) as tar:
            tar.extractall(raw, filter="data")    # plain files: the same files come out

        files = sorted(os.listdir(raw),
                       key=lambda x: (int(re.sub(r"\D", "", x)), x))
        keep = np.setdiff1d(np.arange(len(files), dtype=np.int64),
                            _load_uncharacterized(tmpdir) - 1)
        assert len(keep) == EXPECTED_COUNT, (
            f"expected {EXPECTED_COUNT} molecules, got {len(keep)}"
        )

        records = []
        for k, idx in enumerate(keep):
            if k % 10000 == 0:
                print(f"  parsing {k}/{len(keep)}")
            with open(os.path.join(raw, files[idx])) as f:
                records.append(parse_qm9_xyz(f.read(), idx=int(idx)))

        return save_dataset(records, save_path, "qm9")
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
