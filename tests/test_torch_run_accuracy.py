"""tools/run_accuracy_torch.py: the PyTorch port's one-command accuracy
harness, the twin of tools/run_accuracy.py.

The real QM9/MP2018 downloads are not made here, so these tests pin (a)
the skip guard on a failed download and (b) the whole
preprocess->train->evaluate->verdict chain on the CPU on a synthetic
dataset staged at the expected artifact paths (the layout a real
`process_qm9` run leaves behind), as tests/test_run_accuracy.py does for
the JAX tool."""

import json
import os

import torch
from torch_scripts import load_script

torch.set_num_threads(1)


def tool():
    return load_script("tools", "run_accuracy_torch")


def test_torch_skip_guard_on_download_failure(tmp_path, capsys, monkeypatch):
    """No dataset and a failing download -> exit 3 with a SKIPPED JSON line."""
    from scann_tpu_torch.data import builders

    def fail(save_path):
        raise RuntimeError("download of QM9 failed (no egress)")

    monkeypatch.setitem(builders.BUILDERS, "qm9", fail)
    rc = tool().main(["qm9", "--data-root", str(tmp_path / "pd"), "--device", "cpu"])
    assert rc == 3
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["status"] == "SKIPPED"
    assert out["dataset"] == "qm9" and out["target"] == "homo"
    assert "egress" in out["reason"]


def test_torch_published_targets_equal_the_jax_tool():
    """The twin keeps its own copy of the published MAEs and defaults."""
    run_accuracy = load_script("tools", "run_accuracy")
    mine = tool()
    assert mine.TARGETS_EV == run_accuracy.TARGETS_EV
    assert mine.DEFAULT_TARGET == run_accuracy.DEFAULT_TARGET


def test_torch_full_chain_on_staged_dataset(tmp_path, capsys):
    """Stage a synthetic dataset at the qm9 artifact paths and run the whole
    train->evaluate->verdict chain on the CPU (the flagship config at full
    width, structure packing, 1 epoch, tiny splits). The verdict compares
    against the real published MAE, which a 1-epoch toy run will not meet:
    the exit code must reflect that honestly."""
    from scann_tpu_torch.data.synthetic import make_synthetic_dataset

    root = tmp_path / "processed_data"
    make_synthetic_dataset(str(root / "qm9"), name="qm9", n_structures=160,
                           min_atoms=5, max_atoms=12, seed=3)
    rc = tool().main([
        "qm9", "--data-root", str(root), "--device", "cpu",
        "--save-path", str(tmp_path / "run"),
        "--epochs", "1", "--train-size", "112", "--test-size", "24"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["status"] == "OK"
    assert out["dataset"] == "qm9" and out["target"] == "homo"
    assert out["variant"] == "scann_plus"  # flagship config is g_update
    assert out["published_mae_scann"] == 0.041
    assert out["published_mae_scann_plus"] == 0.032
    assert isinstance(out["test_mae"], float) and out["test_mae"] >= 0
    assert isinstance(out["test_r2"], float) and out["train_s"] >= 0
    assert rc == (0 if out["meets_published"] else 1)
    # the run dir is reusable (config + checkpoints written)
    assert os.path.exists(os.path.join(out["run_dir"], "config.yaml"))
    assert os.path.exists(os.path.join(out["run_dir"], "checkpoints", "best.pt"))
