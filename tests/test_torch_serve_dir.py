"""Serving and predicting from a training run directory of the PyTorch
port, on the CPU: ``BatchedPredictor.from_model_dir`` and the two CLIs with
a positional ``model_dir``, as the JAX package's CLIs take theirs."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from scann_tpu_torch.api import Scann
from scann_tpu_torch.cli import predict_files, serve as serve_cli
from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig, TpuConfig
from scann_tpu_torch.data.structure import Structure
from scann_tpu_torch.data.synthetic import make_synthetic_dataset
from scann_tpu_torch.serve import BatchedPredictor, PredictionServer

torch.set_num_threads(1)

WATER = (["O", "H", "H"], [[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]])
SMALL = dict(n_atoms=10, embedding_dim=16, n_attention=2, local_dim=32, num_head=4,
             global_dim=32, dense_out=16)


@pytest.fixture(autouse=True)
def scipy_voronoi(monkeypatch):
    monkeypatch.setenv("SCANN_TPU_NATIVE_VORONOI", "0")


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory the port trained for one epoch on synthetic molecules."""
    tmp = tmp_path_factory.mktemp("serve_dir")
    energy, nbr = make_synthetic_dataset(str(tmp / "data"), n_structures=24, min_atoms=3,
                                         max_atoms=10, seed=2)
    cfg = ScannConfig(model=ModelConfig(**SMALL),
                      hyper=HyperConfig(batch_size=8, data_energy_path=energy,
                                        data_nei_path=nbr, save_path=str(tmp / "run"),
                                        epochs=1, seed=0),
                      tpu=TpuConfig(max_buckets=2))
    s = Scann(cfg, device="cpu")
    s.prepare_dataset()
    s.train()
    return s.trainer.workdir


def test_torch_batched_predictor_from_model_dir(run_dir):
    want = Scann.load_model_infer(run_dir, device="cpu").predict_structures(
        [Structure(*WATER)])
    p = BatchedPredictor.from_model_dir(run_dir, device="cpu", warmup_shapes=[])
    try:
        got = p.predict([Structure(*WATER)])
    finally:
        p.close()
    assert got[0][0] == want[0][0]
    np.testing.assert_array_equal(got[0][1], want[0][1])


def test_torch_serve_cli_serves_a_run_dir(run_dir, monkeypatch):
    """``cli.serve <model_dir>`` answers a request over HTTP with what the
    run's checkpoint predicts (``serve_forever`` is wrapped so that one
    request is sent and the server returns)."""
    want = Scann.load_model_infer(run_dir, device="cpu").predict_structures(
        [Structure(*WATER)])[0][0]
    answers = []
    real = PredictionServer.serve_forever

    def one_request(self):
        t = threading.Thread(target=real, args=(self,), daemon=True)
        t.start()
        body = json.dumps({"structures": [{"species": WATER[0], "coords": WATER[1]}]})
        req = urllib.request.Request(f"http://{self.host}:{self.port}/predict",
                                     data=body.encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            answers.append(json.loads(r.read()))

    monkeypatch.setattr(PredictionServer, "serve_forever", one_request)
    serve_cli.main([run_dir, "--device", "cpu", "--port", "0", "--warmup", "3x2"])
    assert answers[0]["predictions"][0] == pytest.approx(want, rel=1e-6)
    for bad in ([], [run_dir, "--config", "c.yaml", "--weights", "w.h5"]):
        with pytest.raises(SystemExit):
            serve_cli.main(bad)


def test_torch_predict_files_cli_on_a_run_dir(run_dir, tmp_path):
    xyz = tmp_path / "water.xyz"
    xyz.write_text("3\nwater\nO 0 0 0\nH 0.96 0 0\nH -0.24 0.93 0\n")
    out = tmp_path / "out"
    predict_files.main([run_dir, str(out), str(xyz), "--mol", "--device", "cpu"])
    preds = json.load(open(out / "predictions.json"))
    v, ga = Scann.load_model_infer(run_dir, device="cpu").predict_structure(
        Structure.from_file(str(xyz)))
    assert preds["water"]["prediction"] == pytest.approx(v, rel=1e-6)
    np.testing.assert_allclose(preds["water"]["ga_scores"], ga, rtol=1e-6)
    assert (out / "water_ga.xyz").read_text().splitlines()[0] == "3"
    with pytest.raises(SystemExit):
        predict_files.main([run_dir, str(out)])
