"""The port's host C++ (``native/packer.cc``, ``native/voronoi_cell.cc``)
against its numpy and scipy paths and against the JAX package's native
code, on the CPU; its build (a hash of the bytes, raise on failure); and
the Voronoi path switches (``force``, ``SCANN_TPU_NATIVE_VORONOI``, the
degenerate-cell fallback)."""

import os
import re

import numpy as np
import pytest

from scann_tpu.data import native as jax_native
from scann_tpu.data.structure import Structure as JaxStructure
from scann_tpu.data.voronoi import compute_voronoi_neighbors as jax_neighbors
from scann_tpu_torch.data import native, native_voronoi, pipeline
from scann_tpu_torch.data.pipeline import CsrDataset, load_dataset
from scann_tpu_torch.data.structure import Structure
from scann_tpu_torch.data.synthetic import (_random_crystal, _random_molecule,
                                            make_synthetic_dataset)
from scann_tpu_torch.data.voronoi import (_image_cloud, _voronoi_facets,
                                          compute_voronoi_neighbors)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "scann_tpu_torch")


@pytest.fixture(scope="module")
def csr(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth_native")
    e, n = make_synthetic_dataset(str(out), n_structures=30, min_atoms=4, max_atoms=14, seed=5)
    records, neighbors = load_dataset(e, n, target="homo")
    return CsrDataset(records, neighbors)


@pytest.mark.parametrize("M,N", [(16, 12), (8, 4)])   # the second cuts atoms and neighbours
@pytest.mark.parametrize("weights", ["weight_raw", "weight_norm"])
def test_torch_native_packer_equals_numpy_and_the_jax_packer(csr, M, N, weights):
    rows = np.arange(len(csr.targets))[::-1].copy()
    args = (rows, csr.atom_offsets, csr.nbr_offsets, csr.atomic, csr.nbr_index,
            getattr(csr, weights), csr.nbr_dist, M, N)
    got = pipeline.pack_bucket(*args)
    plain = pipeline.pack_bucket_plain(*args)
    jax = jax_native.pack_bucket_native(*args)
    assert set(got) == set(plain) == set(jax)
    for k in got:
        assert got[k].dtype == plain[k].dtype == jax[k].dtype, k
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
        np.testing.assert_array_equal(got[k], jax[k], err_msg=k)


def test_torch_native_structure_sizes_equal_numpy_and_the_jax_packer(csr):
    got = pipeline.structure_sizes(csr.atom_offsets, csr.nbr_offsets)
    plain = pipeline.structure_sizes_plain(csr.atom_offsets, csr.nbr_offsets)
    jax = jax_native.structure_sizes_native(csr.atom_offsets, csr.nbr_offsets)
    for a, b, c in zip(got, plain, jax):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    with pytest.raises(IndexError):
        native.pack_bucket_native(np.array([len(csr.targets)]), csr.atom_offsets,
                                  csr.nbr_offsets, csr.atomic, csr.nbr_index, csr.weight_raw,
                                  csr.nbr_dist, 8, 8)


def test_torch_pack_dataset_through_the_packer_equals_numpy(csr, monkeypatch, tmp_path):
    out = tmp_path / "d"
    e, n = make_synthetic_dataset(str(out), n_structures=24, min_atoms=3, max_atoms=12, seed=9)
    records, neighbors = load_dataset(e, n, target="homo")
    got = pipeline.pack_dataset(records, neighbors, g_update=True, max_buckets=3)
    monkeypatch.setattr(pipeline, "pack_bucket", pipeline.pack_bucket_plain)
    monkeypatch.setattr(pipeline, "structure_sizes", pipeline.structure_sizes_plain)
    want = pipeline.pack_dataset(records, neighbors, g_update=True, max_buckets=3)
    assert [b.shape for b in got] == [b.shape for b in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.indices, b.indices)
        for k in a.inputs:
            np.testing.assert_array_equal(a.inputs[k], b.inputs[k], err_msg=k)


def _both(struct):
    s = struct.as_periodic()
    fn = _voronoi_facets(s.coords, s.lattice, len(s), 7.0, force="native")
    fs = _voronoi_facets(s.coords, s.lattice, len(s), 7.0, force="scipy")
    assert fn is not None
    return fn, fs


def _agree(fn, fs, atol=1e-9):
    """The same facets (neighbour, solid angle, distance), in any order."""
    assert len(fn) == len(fs)
    for a, b in zip(fn, fs):
        a, b = sorted(a), sorted(b)
        assert [f[0] for f in a] == [f[0] for f in b]
        np.testing.assert_allclose(np.array([f[1:] for f in a]), np.array([f[1:] for f in b]),
                                   rtol=0, atol=atol)


def _structures():
    rng = np.random.default_rng(11)
    out = [("molecule", Structure(*_random_molecule(rng, int(rng.integers(6, 26)))))
           for _ in range(4)]
    out += [("crystal", Structure(*_random_crystal(rng, int(rng.integers(20, 60)))))
            for _ in range(3)]
    lattice = np.array([[4.0, 0.0, 0.0], [1.2, 3.8, 0.0], [0.7, 1.1, 3.5]])
    fr = np.random.default_rng(13).uniform(0.05, 0.95, (5, 3))
    out.append(("triclinic", Structure.from_frac(["Si", "O", "O", "Al", "Mg"], fr, lattice)))
    return out


@pytest.mark.parametrize("i", range(8))
def test_torch_native_voronoi_equals_scipy(i):
    _, struct = _structures()[i]
    _agree(*_both(struct))


def test_torch_native_voronoi_on_degenerate_lattices():
    """Exact lattice symmetry (FCC's rhombic dodecahedron, BCC's truncated
    octahedron): four or more bisectors meet at each cell vertex."""
    fcc = Structure.from_frac(["Cu"] * 4, [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                                           [0, 0.5, 0.5]], np.eye(3) * 4.0)
    bcc = Structure.from_frac(["Fe", "Fe"], [[0, 0, 0], [0.5, 0.5, 0.5]], np.eye(3) * 2.9)
    for struct, faces in ((fcc, 12), (bcc, 14)):
        fn, fs = _both(struct)
        _agree(fn, fs)
        assert [len(f) for f in fn] == [faces] * len(struct)
        for f in fn:
            assert sum(x[1] for x in f) == pytest.approx(4 * np.pi, rel=1e-9)


def _records(struct, monkeypatch, flag):
    monkeypatch.setenv("SCANN_TPU_NATIVE_VORONOI", flag)
    return compute_voronoi_neighbors(struct)


@pytest.mark.parametrize("i", [0, 4, 7])
def test_torch_voronoi_records_equal_across_paths_and_packages(i, monkeypatch):
    _, struct = _structures()[i]
    nat = _records(struct, monkeypatch, "1")
    sci = _records(struct, monkeypatch, "0")
    monkeypatch.setenv("SCANN_TPU_NATIVE_VORONOI", "1")       # the JAX package's default
    jax = jax_neighbors(JaxStructure(list(struct.species), struct.coords, struct.lattice))
    assert nat == jax                                           # the same C++ on both sides
    assert len(nat) == len(sci)
    for a, b in zip(nat, sci):
        assert [(r[0], r[1]) for r in a] == [(r[0], r[1]) for r in b]
        if a:
            np.testing.assert_allclose(np.array([r[2:] for r in a]),
                                       np.array([r[2:] for r in b]), rtol=0, atol=1e-8)


def test_torch_degenerate_cell_falls_back_to_scipy(monkeypatch):
    s = Structure(["C", "O"], [[0, 0, 0], [1.2, 0, 0]]).as_periodic()
    want = _voronoi_facets(s.coords, s.lattice, 2, 7.0, force="scipy")
    monkeypatch.setattr(native_voronoi, "voronoi_facets_native", lambda *a, **k: None)
    assert _voronoi_facets(s.coords, s.lattice, 2, 7.0) == want
    assert _voronoi_facets(s.coords, s.lattice, 2, 7.0, force="native") is None
    # coincident points: the C++ flags the cell, the wrapper returns None
    pts = np.zeros((3, 3))
    pts[2] = [1.0, 0.0, 0.0]
    assert native_voronoi.voronoi_facets_native(pts, 2, np.arange(3)) is None


def test_torch_voronoi_switches(monkeypatch):
    called = []

    def spy(*a, **k):
        called.append(1)
        return None

    monkeypatch.setattr(native_voronoi, "voronoi_facets_native", spy)
    s = Structure(["C", "O"], [[0, 0, 0], [1.2, 0, 0]]).as_periodic()
    monkeypatch.setenv("SCANN_TPU_NATIVE_VORONOI", "0")
    assert _voronoi_facets(s.coords, s.lattice, 2, 7.0) is not None
    assert not called
    monkeypatch.setenv("SCANN_TPU_NATIVE_VORONOI", "1")
    assert _voronoi_facets(s.coords, s.lattice, 2, 7.0, force="scipy") is not None
    assert not called
    _voronoi_facets(s.coords, s.lattice, 2, 7.0)
    assert called == [1]


def test_torch_native_voronoi_grows_its_facet_budget():
    """A budget of 2 overflows (rc 1, count -2); the wrapper retries larger
    and gets the simple-cubic cell's 6 facets."""
    lib = native_voronoi.get_lib()
    s = Structure(["Na"], [[0.0, 0.0, 0.0]], np.eye(3) * 3.0)
    pts, _ = _image_cloud(s.coords, s.lattice, 1, 7.0)
    pts = np.ascontiguousarray(pts, np.float64)
    counts = np.zeros(1, np.int32)
    nbr = np.zeros(2, np.int64)
    sa = np.zeros(2, np.float64)
    dist = np.zeros(2, np.float64)
    assert lib.scann_voronoi_facets(pts, len(pts), 1, 2, counts, nbr, sa, dist) == 1
    assert counts[0] == -2
    out = native_voronoi.voronoi_facets_native(pts, 1, np.zeros(len(pts), np.int64))
    assert len(out[0]) == 6
    for _, sa_, d in out[0]:
        assert sa_ == pytest.approx(4 * np.pi / 6, rel=1e-9) and d == pytest.approx(3.0)


def test_torch_native_build_is_keyed_by_bytes_and_raises_on_failure(tmp_path, monkeypatch):
    src = tmp_path / "packer.cc"
    body = open(os.path.join(native.SRC_DIR, "packer.cc"), "rb").read()
    src.write_bytes(body)
    first = native.library_path(str(src))
    assert first == native.library_path(str(src))
    assert os.path.basename(first).startswith("libpacker_")
    src.write_bytes(body + b"\n// one more line\n")
    edited = native.library_path(str(src))
    assert edited != first
    monkeypatch.setattr(native, "cpu_model", lambda: "another CPU")
    assert native.library_path(str(src)) != edited
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    broken = tmp_path / "broken.cc"
    broken.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_shared_library(str(broken))
    assert not os.listdir(tmp_path / "build")          # no half-written library left


def test_torch_host_and_probe_sources_are_the_ports_own():
    """The two .cc files and the rate probe include only system headers or
    files of the port; every module that builds them points into the port."""
    sources = [os.path.join(PKG, "native", "packer.cc"),
               os.path.join(PKG, "native", "voronoi_cell.cc"),
               os.path.join(PKG, "csrc", "roofline_probe.cu")]
    for path in sources:
        text = open(path).read()
        for inc in re.findall(r'^\s*#\s*include\s+(["<])([^">]+)[">]', text, re.M):
            if inc[0] == '"':
                target = os.path.normpath(os.path.join(os.path.dirname(path), inc[1]))
                assert target.startswith(PKG + os.sep) and os.path.exists(target), inc
    assert native.SRC_DIR == os.path.join(PKG, "native")
    assert os.path.commonpath([native.BUILD_DIR, os.path.join(ROOT, "build")]) == \
        os.path.join(ROOT, "build")
    from scann_tpu_torch.kernels import _build

    assert _build.PROBES == ("roofline_probe",) and "roofline_probe" not in _build.SOURCES
    assert _build.source_files("roofline_probe") == sources[2:]
