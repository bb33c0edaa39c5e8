"""The PyTorch port's dataset builders, parallel featurization and
preprocess CLI against the JAX package's, on the CPU: the parsers on the
payloads of ``test_builders.py`` and ``test_builders_download.py``, every
download -> extract -> parse -> save chain of both packages against one
local HTTP server on 127.0.0.1 (the URLs monkeypatched as the JAX tests do),
the synthetic builder record for record, and the neighbour files of
``parallel_compute_neighbors`` at one and two processes. Both packages
featurize through their scipy/Qhull path (``SCANN_TPU_NATIVE_VORONOI=0``)."""

import json
import os
import re
import zipfile

import numpy as np
import pytest

import test_builders as jb
import test_builders_download as jdl
from scann_tpu.cli.preprocess import main as jax_preprocess_main
from scann_tpu.data import builders as jax_builders
from scann_tpu.data.builders import mp2018 as jax_mp2018
from scann_tpu.data.builders import qm9 as jax_qm9
from scann_tpu.data.builders import qm9_std_jctc as jax_qm9_std
from scann_tpu.data.builders import trajectories as jax_traj
from scann_tpu.data.featurize import parallel_compute_neighbors as jax_parallel_neighbors
from scann_tpu_torch.cli.preprocess import main as preprocess_main
from scann_tpu_torch.data import builders
from scann_tpu_torch.data.builders import common, mp2018, qm9, qm9_std_jctc, trajectories
from scann_tpu_torch.data.featurize import neighbor_file_name, parallel_compute_neighbors
from test_builders_download import fixture_server  # noqa: F401  (the local HTTP server)


@pytest.fixture(autouse=True)
def scipy_voronoi(monkeypatch):
    monkeypatch.setenv("SCANN_TPU_NATIVE_VORONOI", "0")


def same(a, b, path="record"):
    """Equal records: the same keys, types, dtypes and values exactly."""
    assert type(a) is type(b), f"{path}: {type(a)} vs {type(b)}"
    if isinstance(a, dict):
        assert list(a) == list(b), f"{path}: keys {list(a)} vs {list(b)}"
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: length {len(a)} vs {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{path}: {a.dtype}{a.shape}"
        if a.dtype == object:
            same(list(a), list(b), path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, f"{path}: {a!r} vs {b!r}"


def same_neighbors(got, want):
    """Neighbour files: the records' (symbol, index) in the same order,
    their solid angles, weights and distances within 1e-8."""
    assert got.dtype == object and got.shape == want.shape
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for ra, rb in zip(a, b):
            assert [(r[0], r[1]) for r in ra] == [(r[0], r[1]) for r in rb]
            if ra:
                np.testing.assert_allclose(np.array([r[2:] for r in ra], float),
                                           np.array([r[2:] for r in rb], float),
                                           rtol=0, atol=1e-8)


# --- parsers -------------------------------------------------------------------

@pytest.mark.parametrize("text,idx", [(jb.QM9_SAMPLE, 0), (jb.QM9_SCI_NOTATION, None),
                                      (jdl.QM9_XYZ.format(i=7, homo=-0.33), 6)],
                         ids=["methane", "star-exponent", "download-payload"])
def test_torch_parse_qm9_xyz_matches_jax(text, idx):
    same(qm9.parse_qm9_xyz(text, idx=idx), jax_qm9.parse_qm9_xyz(text, idx=idx))


def test_torch_record_from_entry_matches_jax(fixture_server):  # noqa: F811
    _, root = fixture_server
    std = json.loads(zipfile.ZipFile(root / "qm9_std.zip").read("qm9_std_jctc.json"))
    for entry in std:
        same(qm9_std_jctc.record_from_entry(entry), jax_qm9_std.record_from_entry(entry))
    mp = json.loads(zipfile.ZipFile(root / "mp.zip").read("mp.2018.6.1.json"))
    mp.append({"structure": jb.CIF_SYMMETRIZED, "formation_energy_per_atom": 0.1,
               "band_gap": 0.0})
    got = [mp2018.record_from_entry(e, i) for i, e in enumerate(mp)]
    assert got[1] is None and got[-1] is None         # one-atom cells are skipped
    for i, (g, e) in enumerate(zip(got, mp)):
        same(g, jax_mp2018.record_from_entry(e, i))


@pytest.mark.parametrize("kind,text", [("fullerene", jdl.TRAJ_XYZ_FULLERENE),
                                       ("ptgp", jdl.TRAJ_XYZ_PTGP),
                                       ("smfe", jdl.TRAJ_XYZ_SMFE)])
def test_torch_trajectory_records_match_jax(kind, text, tmp_path):
    path = tmp_path / f"{kind}.xyz"
    path.write_text(text)
    frames = list(trajectories.iter_xyz_frames(str(path)))
    same(frames, list(jax_traj.iter_xyz_frames(str(path))))
    make = getattr(trajectories, f"{kind}_record")
    jax_make = getattr(jax_traj, f"{kind}_record")
    for i, frame in enumerate(frames):
        same(make(i, *frame), jax_make(i, *frame))


def test_torch_trajectory_refusals_match_jax():
    """A fullerene frame is refused by the ptgp parser with the JAX
    message, a ptgp frame by the fullerene parser, and an archive without
    Pt by the ptgp check."""
    three, two = "-5.5 -3.2 -100.0", "-200.5 -199.0"
    carbon = (["C"], np.zeros((1, 3), np.float32))
    messages = []
    for mod in (trajectories, jax_traj):
        with pytest.raises(ValueError) as err:
            mod.ptgp_record(0, three, *carbon)
        messages.append(str(err.value))
        with pytest.raises(IndexError):
            mod.fullerene_record(0, two, *carbon)
        with pytest.raises(RuntimeError, match="none contain Pt") as err:
            mod._validate_ptgp_records([mod.ptgp_record(0, two, *carbon)])
        messages.append(str(err.value))
        mod._validate_ptgp_records([mod.ptgp_record(0, two, ["Pt"], carbon[1])])
    assert messages[:2] == messages[2:]


# --- download -> extract -> parse -> save chains --------------------------------

CHAINS = {
    "qm9": (qm9, jax_qm9, "process_qm9",
            {"GDB9_URL": "gdb9.tar.gz", "UNCHARACTERIZED_URL": "uncharacterized.txt",
             "EXPECTED_COUNT": 3}),
    "qm9_std_jctc": (qm9_std_jctc, jax_qm9_std, "process_qm9_std_jctc",
                     {"QM9_STD_URL": "qm9_std.zip"}),
    "mp2018": (mp2018, jax_mp2018, "process_mp2018", {"MP2018_URL": "mp.zip"}),
    "fullerene": (trajectories, jax_traj, "process_fullerene",
                  {"FULLERENE_URL": "fullerene.zip"}),
    "ptgp": (trajectories, jax_traj, "process_ptgp",
             {"PTGP_URLS": ["ptgp_alt.zip", "fullerene.zip"]}),
    "ptgp-fallback": (trajectories, jax_traj, "process_ptgp",
                      {"PTGP_URLS": ["pt_graphene.zip", "fullerene_ptgp_content.zip"]}),
    "smfe": (trajectories, jax_traj, "process_smfe", {"SMFE_URL": "smfe12.zip"}),
}


def _patch(monkeypatch, module, patches, base):
    for name, value in patches.items():
        if isinstance(value, str):
            value = f"{base}/{value}"
        elif isinstance(value, list):
            value = [f"{base}/{v}" for v in value]
        monkeypatch.setattr(module, name, value)


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_torch_builder_chain_matches_jax(chain, fixture_server, tmp_path,  # noqa: F811
                                         monkeypatch):
    base, root = fixture_server
    (root / "fullerene_ptgp_content.zip").write_bytes(
        jdl._zip_bytes({"ptgp/pt.xyz": jdl.TRAJ_XYZ_PTGP}))
    mod, jax_mod, fn, patches = CHAINS[chain]
    _patch(monkeypatch, mod, patches, base)
    _patch(monkeypatch, jax_mod, patches, base)
    got = getattr(mod, fn)(str(tmp_path / "torch"))
    want = getattr(jax_mod, fn)(str(tmp_path / "jax"))
    assert os.path.relpath(got, tmp_path / "torch") == os.path.relpath(want, tmp_path / "jax")
    got, want = np.load(got, allow_pickle=True), np.load(want, allow_pickle=True)
    assert got.dtype == object and got.ndim == 1 and len(got) > 0
    same(got, want)


@pytest.mark.parametrize("urls,error,message", [
    (["pt_graphene.zip", "fullerene.zip"], ValueError, "expected exactly 2 comment tokens"),
    (["missing1.zip", "missing2.zip"], RuntimeError, "all 2 candidate URLs"),
], ids=["fullerene-content", "all-urls-fail"])
def test_torch_ptgp_chain_refusals_match_jax(urls, error, message, fixture_server,  # noqa: F811
                                              tmp_path, monkeypatch, capsys):
    base, _ = fixture_server
    texts = []
    for mod in (trajectories, jax_traj):
        _patch(monkeypatch, mod, {"PTGP_URLS": urls}, base)
        with pytest.raises(error, match=message) as err:
            mod.process_ptgp(str(tmp_path / mod.__name__))
        # the temporary directory a download was to land in differs
        texts.append(re.sub(r"place it at \S+", "place it at <dest>", str(err.value)))
        assert not os.path.exists(tmp_path / mod.__name__ / "ptgp")
    assert texts[0] == texts[1]


def test_torch_download_failure_names_the_way_out(tmp_path):
    with pytest.raises(RuntimeError, match="fetch .* manually") as err:
        common.download("http://127.0.0.1:9/none.zip", str(tmp_path / "x.zip"), "X")
    assert "synthetic" in str(err.value)


def test_torch_builders_registry_matches_jax():
    assert list(builders.BUILDERS) == list(jax_builders.BUILDERS)
    assert [f.__name__ for f in builders.BUILDERS.values()] == \
        [f.__name__ for f in jax_builders.BUILDERS.values()]


# --- synthetic builder, parallel featurization, CLI --------------------------------

@pytest.fixture(scope="module")
def synthetic_pair(tmp_path_factory):
    """The energy files of both packages' synthetic builders (24 molecules)."""
    root = tmp_path_factory.mktemp("torch_synthetic_builder")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCANN_TPU_NATIVE_VORONOI", "0")
        got = builders.process_synthetic(str(root / "torch"), n_structures=24)
        want = jax_builders.process_synthetic(str(root / "jax"), n_structures=24)
    return got, want


def test_torch_process_synthetic_matches_jax(synthetic_pair):
    got, want = synthetic_pair
    assert got.endswith(os.path.join("torch", "synthetic", "synthetic_data_energy.npy"))
    same(np.load(got, allow_pickle=True), np.load(want, allow_pickle=True))


@pytest.mark.parametrize("pool", [1, 2])
def test_torch_parallel_compute_neighbors_matches_jax(pool, synthetic_pair, tmp_path):
    """Chunks of 5 records over the pool (five chunks, the last short): the
    records land by chunk start, so the file does not depend on the pool."""
    energy, _ = synthetic_pair
    got, want = str(tmp_path / "torch.npy"), str(tmp_path / "jax.npy")
    parallel_compute_neighbors(energy, got, d_t=3.5, w_t=0.3, pool=pool, chunk=5)
    jax_parallel_neighbors(energy, want, d_t=3.5, w_t=0.3, pool=1)
    got, want = np.load(got, allow_pickle=True), np.load(want, allow_pickle=True)
    assert len(got) == 24
    same_neighbors(got, want)


def test_torch_preprocess_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """The preprocess CLI end to end on the synthetic builder cut to 48
    structures, as ``test_cli.py`` runs the JAX one: the same two files;
    a second run finds the energy file and featurizes again."""
    for mod in (builders, jax_builders):
        orig = mod.BUILDERS["synthetic"]
        monkeypatch.setitem(mod.BUILDERS, "synthetic",
                            lambda save_path="", orig=orig: orig(save_path, n_structures=48))
    preprocess_main(["synthetic", str(tmp_path / "torch"), "--dt", "4.0", "--wt", "0.4",
                     "--p", "2"])
    jax_preprocess_main(["synthetic", str(tmp_path / "jax"), "--p", "1"])
    name = neighbor_file_name("synthetic", 4.0, 0.4)
    assert name == "synthetic_data_neighbor_dt4.0_wt0.4.npy"
    for f in ("synthetic_data_energy.npy", name):
        got = np.load(tmp_path / "torch" / "synthetic" / f, allow_pickle=True)
        want = np.load(tmp_path / "jax" / "synthetic" / f, allow_pickle=True)
        assert len(got) == 48
        (same if f.endswith("energy.npy") else same_neighbors)(got, want)
    capsys.readouterr()
    preprocess_main(["synthetic", str(tmp_path / "torch"), "--p", "1"])
    assert "Dataset exists" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown dataset"):
        preprocess_main(["qm10", str(tmp_path)])


WORKER_PROBE = """
import json, multiprocessing, sys
import torch  # the caller's own import, which a spawned worker must not repeat
from concurrent.futures import ProcessPoolExecutor
from scann_tpu_torch.data import featurize

if __name__ == "__main__":
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as ex:
        with featurize._main_module_hidden():
            ok = ex.submit(featurize._featurize_chunk, [], 4.0, 0.4)
        ok.result()
        mods = ex.submit(eval, "sorted(__import__('sys').modules)").result()
    print(json.dumps({"worker": [m for m in mods if m.split(".")[0] in ("torch", "scipy")],
                      "file": sys.modules["__main__"].__file__}))
"""


@pytest.mark.parametrize("how", ["script", "module"])
def test_torch_pool_workers_import_no_torch(how, tmp_path):
    """The featurization pool's spawned workers import neither the caller's
    main script or module (and with it torch) nor scipy, and the caller's
    main module is left as it was."""
    import subprocess
    import sys

    (tmp_path / "caller.py").write_text(WORKER_PROBE)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = ["caller.py"] if how == "script" else ["-m", "caller"]
    out = subprocess.run([sys.executable, *args], cwd=tmp_path, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=root), timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["worker"] == []
    assert got["file"] == str(tmp_path / "caller.py")
