"""Minimal crystal/molecule structure representation.

Replaces the reference's pymatgen ``Structure``/``Molecule`` usage
(pymatgen is not a dependency of this framework). Supports exactly what the
SCANN pipeline needs:

- periodic structures with an arbitrary 3x3 lattice,
- molecules, boxed into an orthorhombic periodic cell the same way the
  reference does (>=10 A box, centered center-of-mass; reference
  ``scann/utils/voronoi_neighbor.py:82-87`` / ``general.py:190-196``),
- parsing of .xyz (including extended-xyz ``Lattice="..."`` comment lines,
  reference ``general.py:147-175``) and VASP POSCAR files.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from scann_tpu_torch.data.atomic_data import atomic_masses, atomic_numbers, chemical_symbols


@dataclass
class Structure:
    species: List[str]                   # element symbols, one per site
    coords: np.ndarray                   # cartesian coordinates [n, 3]
    lattice: Optional[np.ndarray] = None  # row-vector lattice [3, 3]; None = molecule
    # True when `lattice` is a synthetic padded box added by boxed() around a
    # molecule (not real periodicity) — lets canonicalized() see through it
    molecule_box: bool = False

    def __post_init__(self):
        # Validate eagerly: Structure is the boundary where user input
        # (serve requests, CLI files, dataset records) enters the framework,
        # and an invalid structure otherwise surfaces as a KeyError/qhull
        # crash deep inside featurization (or, worse, a silently wrong
        # result). Cost is negligible next to one Voronoi tessellation.
        if len(self.species) == 0:
            raise ValueError("structure has no atoms")
        norm = []
        for s in self.species:
            if isinstance(s, (int, np.integer)):  # accept atomic numbers
                if not 0 < int(s) < len(chemical_symbols):
                    raise ValueError(f"atomic number {int(s)} out of range")
                norm.append(chemical_symbols[int(s)])
            else:
                norm.append(str(s))
        unknown = sorted({s for s in norm if s not in atomic_numbers})
        if unknown:
            raise ValueError(f"unknown element symbol(s): {unknown}")
        self.species = norm
        self.coords = np.asarray(self.coords, dtype=np.float64).reshape(-1, 3)
        if self.coords.shape[0] != len(self.species):
            raise ValueError(
                f"{len(self.species)} species but coordinates for "
                f"{self.coords.shape[0]} sites")
        if not np.isfinite(self.coords).all():
            raise ValueError("non-finite atomic coordinates")
        if self.lattice is not None:
            self.lattice = np.asarray(self.lattice, dtype=np.float64).reshape(3, 3)
            if not np.isfinite(self.lattice).all():
                raise ValueError("non-finite lattice")
            if abs(np.linalg.det(self.lattice)) < 1e-9:
                raise ValueError("singular lattice (zero cell volume)")

    def __len__(self) -> int:
        return len(self.species)

    @property
    def is_periodic(self) -> bool:
        return self.lattice is not None

    @property
    def atomic_numbers(self) -> np.ndarray:
        return np.array([atomic_numbers[s] for s in self.species], dtype=np.int32)

    @property
    def masses(self) -> np.ndarray:
        return atomic_masses[self.atomic_numbers]

    @property
    def center_of_mass(self) -> np.ndarray:
        m = self.masses
        return (self.coords * m[:, None]).sum(0) / m.sum()

    @property
    def frac_coords(self) -> np.ndarray:
        assert self.lattice is not None
        return self.coords @ np.linalg.inv(self.lattice)

    # --- construction helpers -------------------------------------------------

    @classmethod
    def from_frac(cls, species, frac_coords, lattice) -> "Structure":
        lattice = np.asarray(lattice, dtype=np.float64).reshape(3, 3)
        cart = np.asarray(frac_coords, dtype=np.float64).reshape(-1, 3) @ lattice
        return cls(list(species), cart, lattice)

    def boxed(self, box: float = 10.0, margin: float = 0.1) -> "Structure":
        """Put a molecule in an orthorhombic periodic box.

        Box edge per axis = max(box, extent + margin), molecule centered at the
        box center by center of mass — matching the reference construction
        (``voronoi_neighbor.py:83-87`` with pymatgen ``get_boxed_structure``).
        """
        ext = self.coords.max(0) - self.coords.min(0)
        abc = np.maximum(box, ext + margin)
        lattice = np.diag(abc)
        coords = self.coords - self.center_of_mass + abc / 2.0
        return Structure(list(self.species), coords, lattice,
                         molecule_box=True)

    def as_periodic(self, box: float = 10.0) -> "Structure":
        return self if self.is_periodic else self.boxed(box)

    def canonicalized(self) -> "Structure":
        """Rotate a molecule into its mass-weighted principal-axes frame.

        The boxed-molecule featurization is weakly frame-dependent (the
        padded box is axis-aligned — see ``data/voronoi.py`` docstring), so
        the same molecule in two orientations featurizes slightly
        differently. Canonicalizing first makes featurization — and hence
        serving predictions — invariant to the client's coordinate frame.
        Opt-in: the default pipeline stays bit-compatible with the
        reference's (which featurizes in whatever frame the file came in).

        Frame: axes = eigenvectors of the mass-weighted covariance of the
        centered coordinates, ordered by descending eigenvalue; the first
        two signs are fixed by the third coordinate moment (falling back to
        the largest-magnitude projection when a moment vanishes by
        symmetry), and the third axis completes a right-handed system. For
        molecules with degenerate principal moments the frame choice within
        the degenerate subspace is symmetry-equivalent, not unstable in
        effect. Truly periodic structures are returned unchanged (their
        lattice IS the frame); a molecule in a synthetic padded box
        (``boxed()``, ``molecule_box=True``) is unboxed, canonicalized, and
        re-boxed."""
        if self.is_periodic:
            if not self.molecule_box:
                return self
            return Structure(list(self.species),
                             self.coords).canonicalized().boxed(
                                 float(np.diag(self.lattice).min()))
        m = self.masses
        c = self.coords - self.center_of_mass
        cov = (c * m[:, None]).T @ c / m.sum()
        evals, vecs = np.linalg.eigh(cov)          # ascending
        vecs = vecs[:, ::-1]                       # descending eigenvalue
        for k in range(2):                         # sign-fix axes 0 and 1
            proj = c @ vecs[:, k]
            moment = float(np.sum(m * proj ** 3))
            if abs(moment) > 1e-8:
                if moment < 0:
                    vecs[:, k] = -vecs[:, k]
            else:
                i = int(np.argmax(np.abs(proj)))
                if abs(proj[i]) > 1e-8 and proj[i] < 0:
                    vecs[:, k] = -vecs[:, k]
        vecs[:, 2] = np.cross(vecs[:, 0], vecs[:, 1])  # right-handed
        return Structure(list(self.species), c @ vecs)

    # --- parsers --------------------------------------------------------------

    @classmethod
    def from_xyz_lines(cls, lines: Sequence[str]) -> "Structure":
        """Parse (extended) xyz: natoms / comment [Lattice="9 floats"] / sites."""
        if not lines or not lines[0].split():
            raise ValueError("empty xyz input")
        try:
            natoms = int(lines[0].split()[0])
        except ValueError:
            raise ValueError(
                f"xyz header must start with the atom count, got "
                f"{lines[0].strip()!r}") from None
        comment = lines[1] if len(lines) > 1 else ""
        lattice = None
        if 'Lattice="' in comment:
            vals = [float(x) for x in comment.split('Lattice="')[1].split('"')[0].split()]
            lattice = np.array(vals, dtype=np.float64).reshape(3, 3)
        else:
            # bare-floats fallback (beyond the reference's quoted form):
            # only EXACTLY nine numeric tokens forming a non-singular cell
            # — a looser match would misread numeric property comments
            # (MD frames, QM9-style rows) as a garbage lattice and skip the
            # molecule boxing entirely
            toks = comment.split()
            if len(toks) == 9 and _all_floats(toks):
                cand = np.array([float(x) for x in toks],
                                dtype=np.float64).reshape(3, 3)
                if abs(np.linalg.det(cand)) > 1e-6:
                    lattice = cand
        species, coords = [], []
        for k, line in enumerate(lines[2 : 2 + natoms]):
            parts = line.split()
            try:
                sym = parts[0]
                if sym.isdigit():
                    sym = chemical_symbols[int(sym)]
                xyz = [float(x) for x in parts[1:4]]
                if len(xyz) != 3:
                    raise ValueError("fewer than 3 coordinates")
            except (ValueError, IndexError) as e:
                raise ValueError(
                    f"malformed xyz site line {k + 3}: {line.strip()!r} "
                    f"({e})") from None
            species.append(sym)
            coords.append(xyz)
        if len(species) != natoms:
            raise ValueError(
                f"xyz declares {natoms} atoms but only {len(species)} site "
                "lines follow (truncated file?)")
        return cls(species, np.array(coords), lattice)

    @classmethod
    def from_xyz(cls, path: str) -> "Structure":
        with open(path) as f:
            return cls.from_xyz_lines(f.readlines())

    @classmethod
    def from_poscar(cls, path: str) -> "Structure":
        with open(path) as f:
            lines = [ln.rstrip() for ln in f]
        if len(lines) < 9:
            raise ValueError(
                f"POSCAR {path} too short ({len(lines)} lines; a minimal "
                "file has 9: comment/scale/3 lattice/symbols/counts/mode/"
                "at least one site)")
        try:
            return cls._parse_poscar_lines(lines)
        except (ValueError, IndexError) as e:
            if isinstance(e, ValueError) and "POSCAR" in str(e):
                raise
            raise ValueError(f"malformed POSCAR {path}: {e}") from None

    @classmethod
    def _parse_poscar_lines(cls, lines: Sequence[str]) -> "Structure":
        scale = float(lines[1].split()[0])
        lattice = np.array([[float(x) for x in lines[i].split()[:3]] for i in (2, 3, 4)])
        if scale < 0:  # negative scale = target volume
            vol = abs(np.linalg.det(lattice))
            scale = (abs(scale) / vol) ** (1.0 / 3.0)
        lattice = lattice * scale
        symbols = lines[5].split()
        counts = [int(x) for x in lines[6].split()]
        idx = 7
        if lines[idx].strip().lower().startswith("s"):  # selective dynamics
            idx += 1
        cartesian = lines[idx].strip().lower().startswith(("c", "k"))
        idx += 1
        if len(lines) < idx + sum(counts):
            raise ValueError(
                f"POSCAR declares {sum(counts)} sites but only "
                f"{len(lines) - idx} coordinate lines follow "
                "(truncated file?)")
        species = [s for s, c in zip(symbols, counts) for _ in range(c)]
        coords = np.array(
            [[float(x) for x in lines[idx + i].split()[:3]] for i in range(sum(counts))]
        )
        if cartesian:
            return cls(species, coords * scale, lattice)
        return cls.from_frac(species, coords, lattice)

    @classmethod
    def from_molfile(cls, path: str) -> "Structure":
        """Parse an MDL molfile (.mol, V2000; also the first record of an
        .sdf): counts line at row 4, then the atom block ``x y z symbol``."""
        with open(path) as f:
            lines = f.readlines()
        if len(lines) < 4:
            raise ValueError(f"molfile {path} too short for a V2000 header")
        try:
            natoms = int(lines[3][0:3])
        except ValueError:
            raise ValueError(
                f"molfile {path}: malformed counts line "
                f"{lines[3].rstrip()!r}") from None
        if len(lines) < 4 + natoms:
            raise ValueError(
                f"molfile {path} declares {natoms} atoms but the atom block "
                f"has only {len(lines) - 4} lines (truncated file?)")
        species, coords = [], []
        for k, line in enumerate(lines[4 : 4 + natoms]):
            parts = line.split()
            if len(parts) < 4:
                raise ValueError(
                    f"molfile {path}: malformed atom line {k + 5}: "
                    f"{line.strip()!r}")
            coords.append([float(x) for x in parts[:3]])
            species.append(parts[3])
        return cls(species, np.array(coords), None)

    @classmethod
    def from_file(cls, path: str, mol: bool = False) -> "Structure":
        """Load a structure from file (xyz, CIF, mol/sdf, POSCAR/CONTCAR/vasp).

        Mirrors the reference ``load_file`` (``general.py:178-203``, which
        defers to pymatgen's format sniffing): ``mol=True`` boxes a
        non-periodic structure into a >=10 A periodic cell.
        """
        low = path.lower()
        if low.endswith(".xyz"):
            s = cls.from_xyz(path)
        elif low.endswith(".cif"):
            from scann_tpu_torch.data.cif import parse_cif

            with open(path) as f:
                s = parse_cif(f.read())
        elif low.endswith((".mol", ".sdf")):
            s = cls.from_molfile(path)
        elif "poscar" in low or "contcar" in low or low.endswith(".vasp"):
            s = cls.from_poscar(path)
        else:
            raise ValueError(f"unsupported structure file format: {path} "
                             "(expected .xyz, .cif, .mol/.sdf, or POSCAR)")
        if mol and not s.is_periodic:
            s = s.boxed()
        return s

    def to_xyz(self, path: str, extra_columns: Optional[np.ndarray] = None,
               comment: str = "") -> None:
        """Write .xyz, optionally with per-atom extra columns (e.g. GA scores
        for OVITO visualization, reference ``predict_files.py:47-59``)."""
        with open(path, "w") as f:
            f.write(f"{len(self)}\n")
            if self.lattice is not None and not comment:
                flat = " ".join(f"{v:.8f}" for v in self.lattice.ravel())
                comment = f'Lattice="{flat}"'
            f.write(comment + "\n")
            for i, (s, c) in enumerate(zip(self.species, self.coords)):
                line = f"{s} {c[0]:.8f} {c[1]:.8f} {c[2]:.8f}"
                if extra_columns is not None:
                    vals = np.atleast_1d(extra_columns[i])
                    line += "".join(f" {v:.8f}" for v in vals)
                f.write(line + "\n")


def _all_floats(tokens) -> bool:
    try:
        [float(t) for t in tokens]
        return True
    except ValueError:
        return False
