"""Minimal CIF parser for the MP2018 dataset.

The mp.2018.6.1 structures are pymatgen-written CIF strings. This parser
handles that dialect: cell parameters, ``_symmetry_equiv_pos_as_xyz`` /
``_space_group_symop_operation_xyz`` operation lists (applied and deduped,
so symmetrized CIFs work too — P1 is the common case), and the atom_site
loop with fractional coordinates.
"""

from __future__ import annotations

import math
import re
from typing import List, Tuple

import numpy as np

from scann_tpu_torch.data.structure import Structure


def _lattice_from_parameters(a, b, c, alpha, beta, gamma) -> np.ndarray:
    """Row-vector lattice from cell parameters (same convention as pymatgen)."""
    alpha_r, beta_r, gamma_r = (math.radians(x) for x in (alpha, beta, gamma))
    val = (math.cos(alpha_r) * math.cos(beta_r) - math.cos(gamma_r)) / (
        math.sin(alpha_r) * math.sin(beta_r)
    )
    val = max(-1.0, min(1.0, val))
    gamma_star = math.acos(val)
    va = [a * math.sin(beta_r), 0.0, a * math.cos(beta_r)]
    vb = [
        -b * math.sin(alpha_r) * math.cos(gamma_star),
        b * math.sin(alpha_r) * math.sin(gamma_star),
        b * math.cos(alpha_r),
    ]
    vc = [0.0, 0.0, float(c)]
    return np.array([va, vb, vc], dtype=np.float64)


def _num(tok: str) -> float:
    """CIF number possibly with uncertainty suffix: '1.234(5)' -> 1.234."""
    return float(re.sub(r"\(.*?\)", "", tok))


def _parse_symop(op: str):
    """'x, y+1/2, -z' -> (rot 3x3, trans 3)."""
    rot = np.zeros((3, 3))
    trans = np.zeros(3)
    for i, part in enumerate(op.lower().split(",")):
        part = part.strip().replace(" ", "")
        for sign, var in re.findall(r"([+-]?)([xyz])", part):
            rot[i, "xyz".index(var)] = -1.0 if sign == "-" else 1.0
        rest = re.sub(r"[+-]?[xyz]", "", part)
        if rest:
            for frac in re.findall(r"[+-]?\d+(?:/\d+|\.\d+)?", rest):
                if "/" in frac:
                    num, den = frac.split("/")
                    trans[i] += float(num) / float(den)
                else:
                    trans[i] += float(frac)
    return rot, trans


def _tokenize_loop_row(line: str) -> List[str]:
    return re.findall(r"'[^']*'|\"[^\"]*\"|\S+", line)


def parse_cif(text: str, site_tol: float = 1e-3) -> Structure:
    lines = [ln for ln in text.splitlines() if ln.strip() and not ln.strip().startswith("#")]

    cell = {}
    symops: List[Tuple[np.ndarray, np.ndarray]] = []
    site_headers: List[str] = []
    site_rows: List[List[str]] = []

    i = 0
    while i < len(lines):
        ln = lines[i].strip()
        low = ln.lower()
        if low.startswith("_cell_length_a"):
            cell["a"] = _num(ln.split()[1])
        elif low.startswith("_cell_length_b"):
            cell["b"] = _num(ln.split()[1])
        elif low.startswith("_cell_length_c"):
            cell["c"] = _num(ln.split()[1])
        elif low.startswith("_cell_angle_alpha"):
            cell["alpha"] = _num(ln.split()[1])
        elif low.startswith("_cell_angle_beta"):
            cell["beta"] = _num(ln.split()[1])
        elif low.startswith("_cell_angle_gamma"):
            cell["gamma"] = _num(ln.split()[1])
        elif low == "loop_":
            headers = []
            j = i + 1
            while j < len(lines) and lines[j].strip().startswith("_"):
                headers.append(lines[j].strip().split()[0].lower())
                j += 1
            rows = []
            while j < len(lines):
                s = lines[j].strip()
                if s.lower() == "loop_" or s.startswith("_") or s.startswith("data_"):
                    break
                rows.append(_tokenize_loop_row(s))
                j += 1
            if any("symop_operation_xyz" in h or "equiv_pos_as_xyz" in h
                   for h in headers):
                col = next(k for k, h in enumerate(headers)
                           if "symop_operation_xyz" in h or "equiv_pos_as_xyz" in h)
                for row in rows:
                    op = row[col].strip("'\"")
                    symops.append(_parse_symop(op))
            elif any(h.startswith("_atom_site_") for h in headers):
                site_headers = headers
                site_rows = rows
            i = j - 1
        i += 1

    missing = {"a", "b", "c", "alpha", "beta", "gamma"} - set(cell)
    if missing:
        raise ValueError(f"CIF missing cell parameters: {missing}")
    lattice = _lattice_from_parameters(cell["a"], cell["b"], cell["c"],
                                       cell["alpha"], cell["beta"], cell["gamma"])

    if not site_rows:
        raise ValueError("CIF has no atom_site loop")

    def col(name):
        for k, h in enumerate(site_headers):
            if h == name:
                return k
        return None

    c_sym = col("_atom_site_type_symbol")
    if c_sym is None:
        c_sym = col("_atom_site_label")
    cx, cy, cz = (col(f"_atom_site_fract_{u}") for u in "xyz")
    if None in (c_sym, cx, cy, cz):
        raise ValueError(f"CIF atom_site loop lacks required columns: {site_headers}")

    if not symops:
        symops = [(np.eye(3), np.zeros(3))]

    species, fracs = [], []
    for row in site_rows:
        try:
            sym = re.sub(r"[\d+\-]+$", "", row[c_sym].strip("'\""))
            base = np.array([_num(row[cx]), _num(row[cy]), _num(row[cz])])
        except (IndexError, ValueError) as e:
            raise ValueError(
                f"malformed CIF atom_site row {row!r}: {e}") from None
        for rot, trans in symops:
            f = (rot @ base + trans) % 1.0
            # dedupe symmetry-equivalent copies — of the SAME species only:
            # a different element at the same position is site disorder
            # (partial occupancy), which the model cannot represent; raise
            # rather than silently predict on the wrong composition
            dup = False
            for j in range(len(fracs) - 1, -1, -1):
                d = np.abs(f - fracs[j])
                d = np.minimum(d, 1.0 - d)
                if np.all(d < site_tol):
                    if species[j] != sym:
                        raise ValueError(
                            f"disordered CIF: {sym} and {species[j]} share "
                            f"site {np.round(f, 4).tolist()} — partial "
                            "occupancy is not supported")
                    dup = True
                    break
            if not dup:
                species.append(sym)
                fracs.append(f)

    return Structure.from_frac(species, np.asarray(fracs), lattice)
