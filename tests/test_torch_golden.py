"""Golden parity of the PyTorch port: its own H5 loader plus its eager model
against the reference TF graph's outputs in ``tests/fixtures`` (the same
seven cases ``test_golden.py`` holds the JAX model to, at the same
tolerances), on the CPU in float32."""

import json
import os

import numpy as np
import pytest
import torch

from scann_tpu_torch.compat import load_h5_params, params_from_jax
from scann_tpu_torch.config import ModelConfig
from scann_tpu_torch.models import ScannModel

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
CASES = ["scann_plus", "scann_base", "scann_ring_eb", "scann_cgcnn",
         "scann_plus_qm9full", "scann_plus_mp2018full", "scann_plus_ptgp11"]


def load_case(name):
    with open(os.path.join(FIXDIR, f"{name}.json")) as f:
        config = json.load(f)
    data = np.load(os.path.join(FIXDIR, f"{name}.npz"))
    inputs = {k[len("input_"):]: data[k] for k in data.files
              if k.startswith("input_")}
    h5 = os.path.join(FIXDIR, f"{name}.h5")
    if not os.path.exists(h5):
        h5 = os.path.join(FIXDIR, f"{name}.weights.h5")
    cfm = ModelConfig(**{k: v for k, v in config["model"].items()
                         if k in ModelConfig.__dataclass_fields__})
    return cfm, config["hyper"]["target"], inputs, data, h5


@pytest.mark.parametrize("name", CASES)
def test_torch_forward_parity_with_reference(name):
    cfm, target, inputs, data, h5 = load_case(name)
    params = params_from_jax(load_h5_params(h5, cfm), cfm)
    model = ScannModel(cfm, mrelu_head=(target == "e_b"), params=params)
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in inputs.items()})
    np.testing.assert_allclose(
        out["property"].numpy(), data["prediction"], rtol=1e-4, atol=2e-5,
        err_msg=f"{name}: prediction mismatch vs reference TF graph")
    np.testing.assert_allclose(
        out["ga_score"].numpy(), data["ga_score"], rtol=1e-4, atol=2e-5,
        err_msg=f"{name}: GA score mismatch vs reference TF graph")


def test_torch_params_from_jax_rejects_mismatch():
    cfm, _, _, _, h5 = load_case("scann_plus")
    tree = load_h5_params(h5, cfm)
    import dataclasses

    with pytest.raises(ValueError, match="missing"):
        params_from_jax(tree, dataclasses.replace(cfm, n_attention=4))
    with pytest.raises(ValueError, match="shapes"):
        params_from_jax(tree, dataclasses.replace(cfm, embedding_dim=8))
    bad = {"params": dict(tree["params"], stray={"kernel": np.zeros(2)})}
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax(bad, cfm)
