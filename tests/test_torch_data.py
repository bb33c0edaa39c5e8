"""The PyTorch port's featurization against the JAX package's, on the CPU:
structures, Voronoi neighbour records and padded model inputs. Both sides
run their scipy/Qhull path (``SCANN_TPU_NATIVE_VORONOI=0``); the native
paths are held to it and to each other in ``test_torch_native.py``."""

import numpy as np
import pytest
import torch

from scann_tpu.api import prepare_input as jax_prepare_input
from scann_tpu.data.structure import Structure as JaxStructure
from scann_tpu.data.voronoi import compute_voronoi_neighbors as jax_neighbors
from scann_tpu_torch.api import prepare_input
from scann_tpu_torch.data.structure import Structure
from scann_tpu_torch.data.voronoi import compute_voronoi_neighbors

torch.set_num_threads(1)

MOLECULES = {
    "water": (["O", "H", "H"], [[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]]),
    "methane": (["C", "H", "H", "H", "H"],
                [[0, 0, 0], [0.6291, 0.6291, 0.6291], [-0.6291, -0.6291, 0.6291],
                 [-0.6291, 0.6291, -0.6291], [0.6291, -0.6291, -0.6291]]),
    "formaldehyde": (["C", "O", "H", "H"],
                     [[0, 0, 0], [1.21, 0, 0], [-0.55, 0.94, 0], [-0.55, -0.94, 0.01]]),
    "lone atom": (["C"], [[0, 0, 0]]),
}


@pytest.fixture(autouse=True)
def scipy_voronoi(monkeypatch):
    monkeypatch.setenv("SCANN_TPU_NATIVE_VORONOI", "0")


def _structures(name):
    species, coords = MOLECULES[name]
    return Structure(species, coords), JaxStructure(species, coords)


def _same_records(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert [(r[0], r[1]) for r in a] == [(r[0], r[1]) for r in b]
        if a:
            np.testing.assert_allclose(np.array([r[2:] for r in a]),
                                       np.array([r[2:] for r in b]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(MOLECULES))
def test_torch_voronoi_matches_jax_on_molecules(name):
    t, j = _structures(name)
    _same_records(compute_voronoi_neighbors(t.as_periodic()),
                  jax_neighbors(j.as_periodic()))
    np.testing.assert_allclose(t.canonicalized().coords, j.canonicalized().coords,
                               rtol=0, atol=1e-12)


def test_torch_voronoi_simple_cubic():
    s = Structure(["Na"], [[0.0, 0.0, 0.0]], np.eye(3) * 3.0)
    recs = compute_voronoi_neighbors(s, d_thresh=4.0, w_thresh=0.4)
    assert len(recs[0]) == 6
    for sym, idx, sa, wn, d in recs[0]:
        assert sym == "Na" and idx == 0
        assert sa == pytest.approx(4 * np.pi / 6, rel=1e-8)
        assert wn == pytest.approx(1.0) and d == pytest.approx(3.0)
    _same_records(recs, jax_neighbors(JaxStructure(["Na"], [[0.0, 0.0, 0.0]],
                                                   np.eye(3) * 3.0)))


def test_torch_voronoi_matches_jax_on_a_crystal():
    rng = np.random.default_rng(0)
    frac = rng.uniform(size=(6, 3))
    lattice = np.array([[4.1, 0.0, 0.0], [0.3, 4.4, 0.0], [0.2, -0.4, 4.8]])
    species = ["Na", "Cl", "Na", "Cl", "O", "O"]
    t = Structure.from_frac(species, frac, lattice)
    j = JaxStructure.from_frac(species, frac, lattice)
    _same_records(compute_voronoi_neighbors(t), jax_neighbors(j))


@pytest.mark.parametrize("kw", [
    dict(angle=True, canonical_frame=True),
    dict(angle=False, canonical_frame=False),
    dict(angle=True, use_ring=True),
    dict(angle=True, feature="cgcnn"),
])
@pytest.mark.parametrize("name", ["water", "formaldehyde", "lone atom"])
def test_torch_prepare_input_matches_jax(name, kw):
    t, j = _structures(name)
    got, want = prepare_input(t, **kw), jax_prepare_input(j, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_torch_structure_parsers_match_jax(tmp_path):
    xyz = tmp_path / "m.xyz"
    xyz.write_text("3\nwater\nO 0 0 0\nH 0.96 0 0\nH -0.24 0.93 0\n")
    cif = tmp_path / "nacl.cif"
    cif.write_text("data_NaCl\n_cell_length_a 5.64\n_cell_length_b 5.64\n"
                   "_cell_length_c 5.64\n_cell_angle_alpha 90\n_cell_angle_beta 90\n"
                   "_cell_angle_gamma 90\nloop_\n_atom_site_type_symbol\n"
                   "_atom_site_label\n_atom_site_fract_x\n_atom_site_fract_y\n"
                   "_atom_site_fract_z\nNa Na1 0 0 0\nCl Cl1 0.5 0.5 0.5\n")
    for path in (xyz, cif):
        t, j = Structure.from_file(str(path)), JaxStructure.from_file(str(path))
        assert t.species == j.species
        np.testing.assert_array_equal(t.coords, j.coords)
        assert (t.lattice is None) == (j.lattice is None)
        if t.lattice is not None:
            np.testing.assert_array_equal(t.lattice, j.lattice)
