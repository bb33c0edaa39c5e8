"""The port's spans and traces (``utils/profiling.py``) and the training
CLI's ``--profile``, on the CPU."""

import glob
import json
import os
import time

import pytest
import torch

from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig, TpuConfig, save_config
from scann_tpu_torch.data.synthetic import make_synthetic_dataset
from scann_tpu_torch.utils import Timer, trace

torch.set_num_threads(1)


def test_torch_timer_accumulates_and_summarises():
    timer = Timer()
    for _ in range(3):
        with timer("featurize"):
            time.sleep(0.01)
    with timer("pad_launch"):
        pass
    with pytest.raises(RuntimeError):
        with timer("pad_launch"):
            raise RuntimeError("the span still ends")
    assert timer.counts == {"featurize": 3, "pad_launch": 2}
    assert timer.totals["featurize"] >= 0.03
    assert timer.totals["pad_launch"] < timer.totals["featurize"]
    lines = timer.summary().splitlines()
    assert lines[0].startswith("featurize: ") and "3 calls" in lines[0]
    assert lines[1].startswith("pad_launch: ") and "2 calls" in lines[1]


def _events(logdir):
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with trace(str(tmp_path / "t"), python_tracer=False) as prof:
        b = a @ a
    assert b.shape == (64, 64)
    names = {e.get("name") for e in _events(str(tmp_path / "t"))}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_torch_train_cli_profile_writes_a_trace(tmp_path):
    from scann_tpu_torch.cli import train

    energy, nbr = make_synthetic_dataset(str(tmp_path / "data"), n_structures=40, min_atoms=3,
                                         max_atoms=10, seed=2)
    cfg = ScannConfig(model=ModelConfig(n_atoms=10, embedding_dim=8, n_attention=1,
                                        local_dim=16, num_head=2, global_dim=16, dense_out=8),
                      hyper=HyperConfig(batch_size=16, scheduler="sgdr",
                                        data_energy_path=energy, data_nei_path=nbr,
                                        save_path=str(tmp_path / "run"), epochs=1, seed=0),
                      tpu=TpuConfig(max_buckets=1))
    path = str(tmp_path / "c.yaml")
    save_config(cfg, path)
    logdir = str(tmp_path / "profile")
    train.main(["homo", path, "--epochs", "1", "--device", "cpu", "--profile", logdir])
    events = _events(logdir)
    assert any(e.get("name") == "aten::mm" for e in events)
    assert os.path.exists(str(tmp_path / "run_homo" / "report.txt"))
