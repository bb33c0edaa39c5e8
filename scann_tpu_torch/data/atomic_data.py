"""Static atomic data tables.

``chemical_symbols`` and ``atomic_masses`` are the standard periodic-table
values (same conventions as ASE; the reference uses the identical symbol list
at ``scann/utils/dataset/atomic_data.py:1-25``).

``atomic_features`` — the 92-dim CGCNN one-hot atom descriptors used for
``feature: "cgcnn"`` mode (reference ``atomic_data.py:27-531``) — is loaded
from the binary asset ``cgcnn_features.npz`` generated by
``tools/make_atomic_features.py``.
"""

import os

import numpy as np

chemical_symbols = [
    # 0 placeholder so that chemical_symbols[Z] == symbol
    "X",
    "H", "He",
    "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
    "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I", "Xe",
    "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm", "Sm", "Eu", "Gd", "Tb", "Dy",
    "Ho", "Er", "Tm", "Yb", "Lu",
    "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn",
    "Fr", "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf",
    "Es", "Fm", "Md", "No", "Lr",
    "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds", "Rg", "Cn",
    "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
]

atomic_numbers = {sym: z for z, sym in enumerate(chemical_symbols)}
atoms_symbol = {str(z): sym for z, sym in enumerate(chemical_symbols)}

# Standard atomic weights (IUPAC 2021 abridged; NaN -> most stable isotope).
# Needed for center-of-mass molecule boxing (pymatgen get_boxed_structure
# centers the molecule's center of mass in the box).
atomic_masses = np.array([
    0.0,
    1.008, 4.0026,
    6.94, 9.0122, 10.81, 12.011, 14.007, 15.999, 18.998, 20.180,
    22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.948,
    39.098, 40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845,
    58.933, 58.693, 63.546, 65.38,
    69.723, 72.630, 74.922, 78.971, 79.904, 83.798,
    85.468, 87.62, 88.906, 91.224, 92.906, 95.95, 97.0, 101.07, 102.91,
    106.42, 107.87, 112.41,
    114.82, 118.71, 121.76, 127.60, 126.90, 131.29,
    132.91, 137.33, 138.91, 140.12, 140.91, 144.24, 145.0, 150.36, 151.96,
    157.25, 158.93, 162.50, 164.93, 167.26, 168.93, 173.05, 174.97,
    178.49, 180.95, 183.84, 186.21, 190.23, 192.22, 195.08, 196.97, 200.59,
    204.38, 207.2, 208.98, 209.0, 210.0, 222.0,
    223.0, 226.0, 227.0, 232.04, 231.04, 238.03, 237.0, 244.0, 243.0, 247.0,
    247.0, 251.0, 252.0, 257.0, 258.0, 259.0, 262.0,
    267.0, 270.0, 269.0, 270.0, 270.0, 278.0, 281.0, 281.0, 285.0,
    286.0, 289.0, 289.0, 293.0, 293.0, 294.0,
])

# Covalent radii in Angstrom (Cordero et al. 2008, as used by ASE);
# 0.2 placeholder for X, 1.5 fallback for elements beyond the table.
covalent_radii = np.array([
    0.2,
    0.31, 0.28,
    1.28, 0.96, 0.84, 0.76, 0.71, 0.66, 0.57, 0.58,
    1.66, 1.41, 1.21, 1.11, 1.07, 1.05, 1.02, 1.06,
    2.03, 1.76, 1.70, 1.60, 1.53, 1.39, 1.39, 1.32, 1.26, 1.24, 1.32, 1.22,
    1.22, 1.20, 1.19, 1.20, 1.20, 1.16,
    2.20, 1.95, 1.90, 1.75, 1.64, 1.54, 1.47, 1.46, 1.42, 1.39, 1.45, 1.44,
    1.42, 1.39, 1.39, 1.38, 1.39, 1.40,
    2.44, 2.15, 2.07, 2.04, 2.03, 2.01, 1.99, 1.98, 1.98, 1.96, 1.94, 1.92,
    1.92, 1.89, 1.90, 1.87, 1.87,
    1.75, 1.70, 1.62, 1.51, 1.44, 1.41, 1.36, 1.36, 1.32,
    1.45, 1.46, 1.48, 1.40, 1.50, 1.50,
] + [1.5] * (119 - 87))

_FEATURES_PATH = os.path.join(os.path.dirname(__file__), "assets", "cgcnn_features.npz")
_atomic_features_cache = None


def get_atomic_features() -> dict:
    """Return the {str(Z): 92-dim float array} CGCNN feature table."""
    global _atomic_features_cache
    if _atomic_features_cache is None:
        data = np.load(_FEATURES_PATH)
        _atomic_features_cache = {k: data[k] for k in data.files}
    return _atomic_features_cache
