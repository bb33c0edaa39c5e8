"""The PyTorch port's example scripts (``examples_torch/``) against the JAX
package's (``examples/``) and its API, on the CPU.

One tiny CPU training run of the port feeds the twins: ``interpretability``
and ``ga_analysis`` read its run directory, ``pretrained_h5`` reads the
TF-golden QM9 fixture checkpoint beside the JAX script, and
``packed_training`` trains on its dataset. The run's weights go to the JAX
package through ``Scann.export_h5``, so both packages predict with the same
parameters. Each script is loaded from its file under a name of its own:
the two directories hold modules of the same names.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_scripts import load_script

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")

# the same molecules through both packages' scripts
XYZ = {
    "water": "3\nwater\nO 0.0 0.0 0.1173\nH 0.0 0.7572 -0.4692\nH 0.0 -0.7572 -0.4692\n",
    "methanol": ("6\nmethanol\nC -0.0467 0.6637 0.0\nO -0.0467 -0.7572 0.0\n"
                 "H -1.0864 0.9811 0.0\nH 0.4384 1.0813 0.8918\nH 0.4384 1.0813 -0.8918\n"
                 "H 0.8689 -1.0868 0.0\n"),
}
# the TF goldens' tolerance (PERF.md section 2): the two packages on the CPU
RTOL, ATOL = 1e-4, 2e-5


def write_molecules(tmp_path):
    paths = []
    for name, text in XYZ.items():
        p = tmp_path / f"{name}.xyz"
        p.write_text(text)
        paths.append(str(p))
    return paths


def recorder(monkeypatch, cls):
    """Record what ``cls.predict_structure`` returns, in call order."""
    got = []
    orig = cls.predict_structure

    def wrapped(self, *args, **kw):
        out = orig(self, *args, **kw)
        got.append(out)
        return out

    monkeypatch.setattr(cls, "predict_structure", wrapped)
    return got


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A run directory of the port, trained on the CPU (checkpoints/best.pt),
    its dataset, and its weights exported as a reference H5."""
    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig
    from scann_tpu_torch.data.synthetic import make_synthetic_dataset

    root = tmp_path_factory.mktemp("examples_torch")
    e, n = make_synthetic_dataset(str(root / "data"), n_structures=48,
                                  min_atoms=4, max_atoms=16, seed=0)
    cfg = ScannConfig(
        model=ModelConfig(n_atoms=16, embedding_dim=8, n_attention=1,
                          local_dim=16, num_head=2, global_dim=16,
                          dense_out=8, g_update=True),
        hyper=HyperConfig(batch_size=16, lr=1e-3, min_lr=1e-4, epochs=2,
                          patience=10, target="homo", train_size=32,
                          test_size=8, data_energy_path=e, data_nei_path=n,
                          save_path=str(root / "model")),
    )
    scann = Scann(cfg, device="cpu")
    scann.prepare_dataset()
    scann.train()
    scann.trainer.restore_checkpoint("best")
    h5 = scann.export_h5(str(root / "weights.h5"))
    return {"workdir": scann.trainer.workdir, "scann": scann, "data": (e, n), "h5": h5}


def jax_scann(run):
    """The JAX package's Scann on the run's config and weights (its H5)."""
    from scann_tpu.api import Scann
    from scann_tpu.config import ScannConfig

    cfg = ScannConfig.from_dict(run["scann"].config.to_dict())
    return Scann(cfg, pretrained=run["h5"], mode="infer")


def parse_pretrained(out: str):
    """[(name, value, [(label, GA)])] from pretrained_h5's printout."""
    rows = []
    for line in out.splitlines():
        if " = " in line and not line.startswith(" "):
            name, rest = line.split(": ", 1)
            rows.append((name, float(rest.split(" = ")[1]), []))
        elif line.strip().startswith("top GA:"):
            for item in line.split("top GA:")[1].split(","):
                label, v = item.strip().split("=")
                rows[-1][2].append((label, float(v)))
    return rows


def test_torch_pretrained_h5_twin_matches_the_jax_script(tmp_path, capsys, monkeypatch):
    """The TF-golden QM9 checkpoint (full flagship width) through
    ``examples/pretrained_h5.py`` and its twin on the same molecules: the
    printed values and the GA scores behind the top-GA lines agree within
    rtol 1e-4, atol 2e-5; the printed top-GA values (3 decimals) agree to
    one unit of their last digit (atoms of equal GA may swap places)."""
    import scann_tpu.api
    import scann_tpu_torch.api

    files = write_molecules(tmp_path)
    argv = [os.path.join(FIXTURES, "scann_plus_qm9full.json"),
            os.path.join(FIXTURES, "scann_plus_qm9full.h5"), *files]
    jax_raw = recorder(monkeypatch, scann_tpu.api.Scann)
    load_script("examples", "pretrained_h5").main(argv)
    jax_out = parse_pretrained(capsys.readouterr().out)
    torch_raw = recorder(monkeypatch, scann_tpu_torch.api.Scann)
    load_script("examples_torch", "pretrained_h5").main(argv + ["--device", "cpu"])
    torch_out = parse_pretrained(capsys.readouterr().out)

    assert [r[0] for r in torch_out] == [r[0] for r in jax_out] == [
        os.path.basename(f) for f in files]
    for (_, vj, topj), (_, vt, topt), (rvj, gj), (rvt, gt) in zip(jax_out, torch_out,
                                                                  jax_raw, torch_raw):
        assert np.isfinite(vt)
        np.testing.assert_allclose(vt, vj, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(rvt, rvj, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL)
        assert len(topt) == len(topj) == min(5, len(gj))
        np.testing.assert_allclose([v for _, v in topt], [v for _, v in topj], atol=1e-3)
        for label, v in topt:
            i = int(label.lstrip("HCNOF"))
            assert abs(v - gj[i]) <= 1e-3, (label, v, gj[i])


def test_torch_interpretability_twin_writes_ga_xyz_and_matches_jax(run, tmp_path):
    """The twin on the port's run directory writes ``<name>_ga.xyz`` with the
    GA score as column 5 (summing to 1, as ``tests/test_examples.py``
    checks); the JAX package, on the same weights (the run's H5 export),
    predicts the same values and GA scores within rtol 1e-4, atol 2e-5."""
    files = write_molecules(tmp_path)
    out = tmp_path / "ga_out"
    got = load_script("examples_torch", "interpretability").main(
        ["--model-dir", run["workdir"], "--out", str(out), "--device", "cpu", *files])
    assert list(got) == list(XYZ)
    jax = jax_scann(run)
    for name, text in XYZ.items():
        lines = (out / f"{name}_ga.xyz").read_text().strip().splitlines()
        n = int(text.split()[0])
        assert lines[0].strip() == str(n) and len(lines) == n + 2
        scores = np.array([float(l.split()[4]) for l in lines[2:]])
        assert abs(scores.sum() - 1.0) < 1e-3
        value, ga = got[name]
        np.testing.assert_allclose(scores, ga, atol=1e-8)     # written at 8 decimals
        want_value, want_ga = jax.predict_structure(str(tmp_path / f"{name}.xyz"))
        np.testing.assert_allclose(value, want_value, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ga, np.asarray(want_ga), rtol=RTOL, atol=ATOL)


def test_torch_ga_analysis_twin_matches_jax_predict_data(run, tmp_path, capsys):
    """The twin's CSV: the JAX script's header, one row per structure, and
    its prediction and ``ga_ratio_*`` columns equal the JAX package's
    ``predict_data`` on the same H5 weights and dataset to the printed
    precision (one unit of the last printed digit: 6 and 4 decimals)."""
    from scann_tpu.data.atomic_data import chemical_symbols
    from scann_tpu.data.pipeline import load_dataset

    out = tmp_path / "ga.csv"
    preds, gas = load_script("examples_torch", "ga_analysis").main(
        [run["workdir"], "--out", str(out), "--device", "cpu"])
    assert "48 structures; target homo" in capsys.readouterr().out
    rows = [r.split(",") for r in out.read_text().strip().splitlines()]
    header = rows[0]
    assert ",".join(header).startswith("structure,prediction,target,ga_ratio_")
    assert len(rows) == 1 + 48 and len(preds) == len(gas) == 48

    jax = jax_scann(run)
    want_preds, want_gas = jax.predict_data(jax.prepare_dataset(split=False), with_ga=True)
    cfg = run["scann"].config.hyper
    records, _ = load_dataset(cfg.data_energy_path, cfg.data_nei_path, cfg.target)
    elems = [h[len("ga_ratio_"):] for h in header[3:]]
    for row, rec, p, ga in zip(rows[1:], records, want_preds, want_gas):
        assert abs(float(row[1]) - float(p)) <= 1e-6, (row[1], p)
        ratios = np.asarray(ga) * len(rec["atomic"])
        for e, cell in zip(elems, row[3:]):
            sel = np.array([chemical_symbols[int(z)] == e for z in rec["atomic"]])
            if not sel.any():
                assert cell == "nan"
                continue
            assert abs(float(cell) - float(ratios[sel].mean())) <= 1e-4, (e, cell)


def test_torch_packed_training_twin_occupancy_equals_jax(run, tmp_path):
    """``run_once`` of the twin, packed, on the run's dataset: finite, with
    the JAX demo's keys, occupancy above 0.85, and that occupancy equal,
    exactly, to the JAX package's ``prepare_dataset`` on the same dataset
    and config (packing is host code; the JAX side trains nothing)."""
    from scann_tpu.api import Scann
    from scann_tpu.config import ScannConfig

    e, n = run["data"]
    tiny = {"n_atoms": 16, "embedding_dim": 8, "n_attention": 1,
            "local_dim": 16, "num_head": 2, "global_dim": 16,
            "dense_out": 8, "g_update": True}
    res = load_script("examples_torch", "packed_training").run_once(
        str(tmp_path / "run"), e, n, epochs=2, packing=True, model=tiny, device="cpu")
    assert set(res) == {"occupancy", "structs_per_sec", "epoch_s", "preds", "slot_batch",
                        "val_mae"}
    assert res["occupancy"] > 0.85
    assert res["structs_per_sec"] > 0 and res["epoch_s"] > 0
    assert np.isfinite(res["val_mae"]) and np.isfinite(res["preds"]).all()
    assert res["preds"].shape == (48,) and res["slot_batch"] >= 1

    jax = Scann(ScannConfig.from_dict({
        "model": tiny,
        "hyper": {"batch_size": 32, "lr": 1e-3, "min_lr": 1e-4, "epochs": 2, "patience": 20,
                  "target": "homo", "save_path": str(tmp_path / "jax"),
                  "data_energy_path": e, "data_nei_path": n},
        "tpu": {"structure_packing": True, "pack_max_segments": 6}}))
    jax.prepare_dataset()
    occ = [float(b.inputs["atom_mask"].sum()
                 / (b.inputs["atom_mask"].shape[0] * b.inputs["atom_mask"].shape[1]))
           for b in jax.train_buckets]
    assert res["occupancy"] == float(np.mean(occ))


def test_torch_twins_load_no_jax_no_scann_tpu(run, tmp_path):
    """In a fresh interpreter, every twin (and the notebook generator)
    imports, and ``interpretability``, ``ga_analysis`` and
    ``packed_training`` run on the CPU, without loading JAX or any module
    of the JAX package; those three need neither yaml nor h5py, which only
    ``pretrained_h5``, the notebooks and ``run_accuracy_torch`` are
    documented to need."""
    files = write_molecules(tmp_path)
    e, n = run["data"]
    probe = f"""
import json, sys
sys.path.insert(0, {os.path.join(ROOT, "tests")!r})
from torch_scripts import load_script as load
load("examples_torch", "interpretability").main(
    ["--model-dir", {run["workdir"]!r}, "--out", {str(tmp_path / "out")!r}, "--device", "cpu",
     *{files!r}])
load("examples_torch", "ga_analysis").main(
    [{run["workdir"]!r}, "--out", {str(tmp_path / "ga.csv")!r}, "--device", "cpu"])
load("examples_torch", "packed_training").run_once(
    {str(tmp_path / "packed")!r}, {e!r}, {n!r}, 1, True, device="cpu")
first = sorted(sys.modules)
load("examples_torch", "pretrained_h5")
load("tools", "run_accuracy_torch")
load("tools", "make_notebooks_torch")
print(json.dumps([first, sorted(sys.modules)]))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", probe], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    first, every = json.loads(out.stdout.strip().splitlines()[-1])
    assert "scann_tpu_torch.api" in first and "examples_torch_make_notebooks_torch" not in first
    assert "tools_make_notebooks_torch" in every and "examples_torch_pretrained_h5" in every

    def jax_or_reference(mods):
        return [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "scann_tpu")]

    assert jax_or_reference(every) == []
    assert [m for m in first if m.split(".")[0] in ("yaml", "h5py")] == []


def test_torch_twins_raise_without_a_card_unless_asked_for_the_cpu(run, tmp_path):
    """Each twin's default device is CUDA; with no card it raises as
    ``api.resolve_device`` does, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    files = write_molecules(tmp_path)
    e, n = run["data"]
    calls = [
        lambda: load_script("examples_torch", "interpretability").main(
            ["--model-dir", run["workdir"], "--out", str(tmp_path / "o"), *files]),
        lambda: load_script("examples_torch", "ga_analysis").main(
            [run["workdir"], "--out", str(tmp_path / "g.csv")]),
        lambda: load_script("examples_torch", "packed_training").run_once(
            str(tmp_path / "p"), e, n, 1, True),
        lambda: load_script("examples_torch", "pretrained_h5").main(
            [os.path.join(FIXTURES, "scann_plus_qm9full.json"),
             os.path.join(FIXTURES, "scann_plus_qm9full.h5"), files[0]]),
        lambda: load_script("tools", "run_accuracy_torch").main(
            ["qm9", "--data-root", str(tmp_path / "pd"), "--epochs", "1"]),
    ]
    from scann_tpu_torch.data.synthetic import make_synthetic_dataset

    make_synthetic_dataset(str(tmp_path / "pd" / "qm9"), name="qm9", n_structures=24,
                           min_atoms=4, max_atoms=8, seed=1)
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
