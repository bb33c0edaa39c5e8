"""The PyTorch port's inference API, serving and CLI on the CPU, against the
JAX package where both exist. The port runs on the CPU only because each
test asks for ``device="cpu"``."""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from scann_tpu.api import Scann as JaxScann
from scann_tpu.config import HyperConfig as JaxHyper
from scann_tpu.config import ModelConfig as JaxModel
from scann_tpu.config import ScannConfig as JaxConfig
from scann_tpu.config import TpuConfig as JaxTpu
from scann_tpu.data.structure import Structure as JaxStructure
from scann_tpu_torch.api import Scann, _ladder
from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig, save_config
from scann_tpu_torch.data.structure import Structure
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.serve import BatchedPredictor, PredictionServer, _Request

torch.set_num_threads(1)

SMALL = dict(n_atoms=10, embedding_dim=16, n_attention=2, local_dim=32, num_head=4,
             global_dim=32, dense_out=16, g_update=True)
MOLS = {
    "water": (["O", "H", "H"], [[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]]),
    "methane": (["C", "H", "H", "H", "H"],
                [[0, 0, 0], [0.6291, 0.6291, 0.6291], [-0.6291, -0.6291, 0.6291],
                 [-0.6291, 0.6291, -0.6291], [0.6291, -0.6291, -0.6291]]),
    "co": (["C", "O"], [[0, 0, 0], [1.13, 0, 0]]),
    "carbon": (["C"], [[0, 0, 0]]),
}
WATER = Structure(*MOLS["water"])
CO = Structure(*MOLS["co"])


@pytest.fixture(autouse=True)
def scipy_voronoi(monkeypatch):
    monkeypatch.setenv("SCANN_TPU_NATIVE_VORONOI", "0")


@pytest.fixture(scope="module")
def scann():
    cfg = ScannConfig(model=ModelConfig(**SMALL),
                      hyper=HyperConfig(batch_size=4, target="homo",
                                        target_mean=-0.2, target_std=0.03))
    s = Scann(cfg, device="cpu")
    s.init_params(seed=0)
    return s


def test_torch_predict_structures_matches_jax(tmp_path):
    """Same flax parameters, same structures: the port's serving path
    (featurize, ladder grouping, wrap-padded batches, un-standardize)
    against the JAX package's."""
    jcfg = JaxConfig(model=JaxModel(**SMALL),
                     hyper=JaxHyper(batch_size=3, target="homo", target_mean=-0.2,
                                    target_std=0.03, save_path=str(tmp_path / "jax")),
                     tpu=JaxTpu(use_pallas=False))
    js = JaxScann(jcfg)
    js.trainer.init_state(js._example_inputs(), seed=3)
    params = jax.device_get(js.trainer.state.params)
    ts = Scann(ScannConfig.from_dict(dataclasses.asdict(jcfg)), device="cpu")
    ts.load_params(params)
    names = ["water", "methane", "co", "carbon", "water"]
    want = js.predict_structures([JaxStructure(*MOLS[n]) for n in names])
    got = ts.predict_structures([Structure(*MOLS[n]) for n in names])
    for (v, ga), (jv, jga) in zip(got, want):
        assert v == pytest.approx(float(jv), rel=1e-5, abs=1e-6)
        np.testing.assert_allclose(ga, np.asarray(jga), rtol=1e-5, atol=1e-6)
    single = ts.predict_structure(Structure(*MOLS["methane"]))
    assert single[0] == pytest.approx(got[1][0], rel=1e-6)


def test_torch_scann_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scann(ScannConfig())


def test_torch_kernel_wrapper_rejects_bad_indices():
    cfm = ModelConfig(**SMALL)
    B, M, N = 2, 8, 4
    inputs = {
        "atomic": torch.ones(B, M, dtype=torch.int32),
        "atom_mask": torch.ones(B, M, 1),
        "neighbors": torch.zeros(B, M, N, dtype=torch.int32),
        "neighbor_mask": torch.ones(B, M, N),
        "neighbor_weight": torch.ones(B, M, N),
        "neighbor_distance": torch.ones(B, M, N),
    }
    cpu = torch.device("cpu")
    assert kfwd._check_inputs(inputs, cfm, cpu) == (B, M, N)
    bad_z = dict(inputs, atomic=torch.full((B, M), cfm.n_atoms, dtype=torch.int32))
    with pytest.raises(ValueError, match="atomic numbers"):
        kfwd._check_inputs(bad_z, cfm, cpu)
    for v in (-1, M):
        bad_n = dict(inputs, neighbors=torch.full((B, M, N), v, dtype=torch.int32))
        with pytest.raises(ValueError, match="neighbor indices"):
            kfwd._check_inputs(bad_n, cfm, cpu)
    with pytest.raises(ValueError, match="neighbors"):
        kfwd._check_inputs(dict(inputs, neighbors=inputs["neighbors"].long()), cfm, cpu)
    packed = kfwd.pack_params(Scann(ScannConfig(model=cfm), device="cpu").init_params(), cfm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kfwd.launch_scann_forward(packed, inputs, cfm)


def test_torch_ladder_matches_jax():
    from scann_tpu.api import _ladder as jax_ladder

    for x in range(1, 400, 3):
        for base in (1, 8):
            assert _ladder(x, base) == jax_ladder(x, base)


def test_torch_http_server_json_xyz_400_413(scann):
    server = PredictionServer(BatchedPredictor(scann, window_ms=0.0, warmup_shapes=[]),
                              port=0, max_body_bytes=2048)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://{server.host}:{server.port}"

    def post(data, ctype="application/json"):
        req = urllib.request.Request(base + "/predict", data=data,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def status(data, ctype="application/json"):
        with pytest.raises(urllib.error.HTTPError) as exc:
            post(data, ctype)
        return exc.value.code

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok", "target": "homo"}
        out = post(json.dumps({"structures": [
            {"species": MOLS["water"][0], "coords": MOLS["water"][1], "lattice": None},
        ]}).encode())
        assert len(out["predictions"]) == 1 and len(out["ga_scores"][0]) == 3
        assert out["predictions"][0] == pytest.approx(
            scann.predict_structures([WATER])[0][0], rel=1e-6)
        xyz = b"3\nwater\nO 0 0 0\nH 0.96 0 0\nH -0.24 0.93 0\n2\nco\nC 0 0 0\nO 1.13 0 0\n"
        out2 = post(xyz, "text/plain")
        assert out2["batch_size"] == 2
        assert out2["predictions"][0] == pytest.approx(out["predictions"][0], rel=1e-5)
        assert status(b"not json") == 400
        assert status(json.dumps({"structures": []}).encode()) == 400
        for structs in ([{"species": ["O", "Xx"], "coords": [[0, 0, 0], [1, 0, 0]]}],
                        [{"species": ["O", "H"], "coords": [[0, 0, 0]]}],
                        [{"species": ["O"], "coords": [[0, 0, float("nan")]]}]):
            assert status(json.dumps({"structures": structs}).encode()) == 400
        assert status(b"x" * 3000) == 413
    finally:
        server.shutdown()


CIF = """data_{name}
_cell_length_a {a:.6f}
_cell_length_b {a:.6f}
_cell_length_c {a:.6f}
_cell_angle_alpha 90.0
_cell_angle_beta 90.0
_cell_angle_gamma 90.0
loop_
_atom_site_type_symbol
_atom_site_fract_x
_atom_site_fract_y
_atom_site_fract_z
"""


def _crystal_cif(name, n_sites, seed):
    """A synthetic periodic crystal of the JAX package's generator, as P1 CIF
    text (fractional coordinates rounded to 6 decimals)."""
    from scann_tpu.data.synthetic import _random_crystal

    syms, coords, lattice = _random_crystal(np.random.default_rng(seed), n_sites)
    a = float(lattice[0, 0])
    return CIF.format(name=name, a=a) + "".join(
        f"{s} {x:.6f} {y:.6f} {z:.6f}\n" for s, (x, y, z) in zip(syms, coords / a))


def test_torch_http_server_serves_crystal_cif(tmp_path):
    """Crystals posted as CIF text and as JSON with a lattice reach the
    periodic Voronoi path and ladder rungs above 64 atoms, end to end on the
    CPU, and give what the JAX package predicts for the same file."""
    from scann_tpu.data.builders.cif import parse_cif as jax_parse_cif
    from scann_tpu_torch.data.cif import parse_cif

    model = dict(SMALL, n_atoms=30)
    jcfg = JaxConfig(model=JaxModel(**model),
                     hyper=JaxHyper(batch_size=2, target="e_form", scaler=False,
                                    save_path=str(tmp_path / "jax")),
                     tpu=JaxTpu(use_pallas=False))
    js = JaxScann(jcfg)
    js.trainer.init_state(js._example_inputs(), seed=5)
    ts = Scann(ScannConfig.from_dict(dataclasses.asdict(jcfg)), device="cpu")
    ts.load_params(jax.device_get(js.trainer.state.params))
    big, small = _crystal_cif("big", 70, 1), _crystal_cif("small", 9, 2)
    want = js.predict_structures([jax_parse_cif(big), jax_parse_cif(small)])

    shapes = []
    forward_eval = ts.forward_eval
    ts.forward_eval = lambda params, batch: (shapes.append(batch["neighbors"].shape[1:]),
                                             forward_eval(params, batch))[1]
    server = PredictionServer(BatchedPredictor(ts, window_ms=0.0, warmup_shapes=[]), port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()

    def post(data, ctype):
        req = urllib.request.Request(f"http://{server.host}:{server.port}/predict", data=data,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    try:
        out = post((big + small).encode(), "text/plain")         # two data_ blocks
        s = parse_cif(big)
        as_json = post(json.dumps({"structures": [{
            "species": s.species, "coords": s.coords.tolist(),
            "lattice": s.lattice.tolist()}]}).encode(), "application/json")
    finally:
        server.shutdown()
    assert out["batch_size"] == 2 and [len(g) for g in out["ga_scores"]] == [70, 9]
    for i, (v, ga) in enumerate(want):
        assert out["predictions"][i] == pytest.approx(float(v), rel=1e-4, abs=1e-5)
        np.testing.assert_allclose(out["ga_scores"][i], np.asarray(ga), rtol=1e-4, atol=1e-5)
    assert as_json["predictions"][0] == pytest.approx(out["predictions"][0], rel=1e-5)
    assert max(M for M, _ in shapes) == _ladder(70, 8) == 96       # a rung above 64 atoms
    assert all(M == _ladder(M, 8) and N == _ladder(N, 8) for M, N in shapes)


def test_torch_batched_predictor_coalesces(scann):
    p = BatchedPredictor(scann, max_batch=16, window_ms=30.0, warmup_shapes=[(3, 2)])
    assert p.warmed == [(8, 8)]
    try:
        results = [None, None]

        def call(i, structs):
            results[i] = p.predict(structs)

        threads = [threading.Thread(target=call, args=(0, [WATER])),
                   threading.Thread(target=call, args=(1, [CO, WATER]))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert len(results[0]) == 1 and len(results[1]) == 2
        assert results[1][1][0] == pytest.approx(results[0][0][0], rel=1e-5)
    finally:
        p.close()


def test_torch_close_fails_deferred_request(scann):
    """A request deferred for the next coalescing cycle is failed by close(),
    not stranded until its client times out."""
    p = BatchedPredictor(scann, warmup_shapes=[])
    p._stop.set()
    for w in p._workers:
        w.join(5)
    req = _Request(structs=[WATER])
    p._deferred = req
    p.close()
    assert req.event.is_set() and isinstance(req.error, RuntimeError)


def test_torch_predict_files_cli(tmp_path):
    """The port's CLI on a reference H5 writes GA-score xyz files and the
    predictions the JAX package computes from the same checkpoint."""
    from scann_tpu_torch.cli import predict_files

    fixture = json.load(open("tests/fixtures/scann_plus.json"))
    cfg = ScannConfig.from_dict({"model": fixture["model"], "hyper": {"target": "homo"}})
    cfg_path = str(tmp_path / "config.yaml")
    save_config(cfg, cfg_path)
    xyz = tmp_path / "water.xyz"
    xyz.write_text("3\nwater\nO 0 0 0\nH 0.96 0 0\nH -0.24 0.93 0\n")
    out = tmp_path / "out"
    predict_files.main(["--config", cfg_path, "--weights", "tests/fixtures/scann_plus.h5",
                        "--device", "cpu", str(out), str(xyz)])
    preds = json.load(open(out / "predictions.json"))
    lines = (out / "water_ga.xyz").read_text().splitlines()
    assert lines[0] == "3" and len(lines[2].split()) == 5
    js = JaxScann(JaxConfig.from_dict({"model": fixture["model"],
                                       "hyper": {"target": "homo",
                                                 "save_path": str(tmp_path / "j")}}),
                  pretrained="tests/fixtures/scann_plus.h5")
    v, ga = js.predict_structure(JaxStructure.from_file(str(xyz)))
    assert preds["water"]["prediction"] == pytest.approx(v, rel=1e-5, abs=1e-6)
    np.testing.assert_allclose(preds["water"]["ga_scores"], ga, rtol=1e-5, atol=1e-6)


def test_torch_serving_launches_each_group_at_its_own_size(tmp_path):
    """A group's last batch runs at the group's own remainder, not wrap-padded
    to ``batch_size``: a lone structure is one batch of B=1. The answers equal
    the wrap-padded batches' and the JAX package's on the same weights."""
    jcfg = JaxConfig(model=JaxModel(**SMALL),
                     hyper=JaxHyper(batch_size=3, target="homo", target_mean=-0.2,
                                    target_std=0.03, save_path=str(tmp_path / "jax")),
                     tpu=JaxTpu(use_pallas=False))
    js = JaxScann(jcfg)
    js.trainer.init_state(js._example_inputs(), seed=4)
    ts = Scann(ScannConfig.from_dict(dataclasses.asdict(jcfg)), device="cpu")
    ts.load_params(jax.device_get(js.trainer.state.params))
    names = ["water", "methane", "co", "carbon", "water", "methane", "water", "water"]
    sizes = []
    forward_eval = ts.forward_eval
    ts.forward_eval = lambda params, batch: (sizes.append(batch["atomic"].shape[0]),
                                             forward_eval(params, batch))[1]
    structs, inputs = ts.featurize_structures([Structure(*MOLS[n]) for n in names])
    got = ts.predict_featurized(structs, inputs)
    assert sizes == [3, 3, 2]          # one (M, N) rung; its tail is 2 structures, not 3
    want = js.predict_structures([JaxStructure(*MOLS[n]) for n in names])
    for (v, ga), (jv, jga) in zip(got, want):
        assert v == pytest.approx(float(jv), rel=1e-5, abs=1e-6)
        np.testing.assert_allclose(ga, np.asarray(jga), rtol=1e-5, atol=1e-6)
    # the same structure alone, and wrap-padded to batch_size copies of itself
    sizes.clear()
    (lone,) = ts.predict_featurized(structs[3:4], inputs[3:4])
    assert sizes == [1]
    padded = {k: np.concatenate([v] * 3) for k, v in inputs[3].items()}
    p, g = forward_eval(ts.params, padded)
    for row in range(3):
        assert lone[0] == pytest.approx(float(p[row, 0]) * 0.03 - 0.2, rel=1e-5, abs=1e-6)
        np.testing.assert_allclose(lone[1], g[row, :1, 0].numpy(), rtol=1e-5, atol=1e-6)
    assert lone[0] == pytest.approx(got[3][0], rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("bad", ["atomic", "neighbor low", "neighbor high"])
def test_torch_launch_check_reads_no_index_back(bad, monkeypatch):
    """The launch wrappers' check (``_check_shapes``) reads the tensors'
    metadata only: it passes a batch with an index out of range and never
    reaches ``index_bounds``; ``_check_inputs``, what a direct caller runs,
    refuses the same batch."""
    import scann_tpu_torch.models.scann as model_mod

    cfm = ModelConfig(**SMALL)
    B, M, N = 2, 8, 4
    inputs = {
        "atomic": torch.ones(B, M, dtype=torch.int32),
        "atom_mask": torch.ones(B, M, 1),
        "neighbors": torch.zeros(B, M, N, dtype=torch.int32),
        "neighbor_mask": torch.ones(B, M, N),
        "neighbor_weight": torch.ones(B, M, N),
        "neighbor_distance": torch.ones(B, M, N),
    }
    key, value = {"atomic": ("atomic", cfm.n_atoms), "neighbor low": ("neighbors", -1),
                  "neighbor high": ("neighbors", M)}[bad]
    inputs[key] = torch.full_like(inputs[key], value)
    cpu = torch.device("cpu")
    real = model_mod.index_bounds
    reads = []
    monkeypatch.setattr(model_mod, "index_bounds", lambda *a: reads.append(1) or real(*a))
    assert kfwd._check_shapes(inputs, cfm, cpu) == (B, M, N)
    assert reads == []
    with pytest.raises(ValueError, match="atomic numbers" if bad == "atomic" else "neighbor"):
        kfwd._check_inputs(inputs, cfm, cpu)
    assert reads == [1]


def test_torch_index_ranges_are_checked_once_before_the_launch(scann, monkeypatch):
    """A served batch is checked once where it enters, ``Scann.forward_eval``:
    numpy arrays on the host before their copy (a bad index raises the
    wrappers' ValueError), tensors with one read-back. On the card the
    trainer's route and the kernel's launch wrapper then read nothing back:
    they take no range flag."""
    import scann_tpu_torch.models.scann as model_mod
    from scann_tpu_torch.train import loop as train_loop

    batch = scann._example_inputs(M=8, N=4, B=2)
    bad = dict(batch, neighbors=np.full((2, 8, 4), 8, np.int32))
    with pytest.raises(ValueError, match="neighbor indices"):
        scann.forward_eval(scann.params, bad)
    reads = []
    real = model_mod.index_bounds
    monkeypatch.setattr(model_mod, "index_bounds",
                        lambda *a: reads.append(type(a[0]).__name__) or real(*a))
    trainer = train_loop.Trainer(scann.config, "cpu", "unused")
    trainer.load_params(scann.params)
    trainer.device = torch.device("cuda")       # only the dispatch reads it here
    launched = []
    monkeypatch.setattr(train_loop, "launch_scann_forward",
                        lambda *a, **kw: launched.append(kw) or (None, None))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    trainer.forward_eval(trainer.params, tbatch)
    assert reads == [] and launched == [{}]
    scann.forward_eval(scann.params, batch)
    assert reads == ["ndarray"]
    scann.forward_eval(scann.params, tbatch)
    assert reads == ["ndarray", "Tensor"]


def test_torch_featurization_failure_falls_back_on_the_device_thread(scann, monkeypatch):
    """In overlap mode a batch that fails to featurize is handed to the
    device thread, which answers its requests one by one: the good requests
    of the batch get their answers, the bad one its error, and no launch runs
    on the featurizer thread."""
    featurize = scann.featurize_structures
    predict = scann.predict_structures
    threads = []

    def flaky(structs, **kw):
        if any(s.species == ["C"] for s in structs):
            raise ValueError("injected featurization failure")
        return featurize(structs, **kw)

    def recorded(structs, **kw):
        threads.append(threading.current_thread().name)
        return predict(structs, **kw)

    monkeypatch.setattr(scann, "featurize_structures", flaky)
    monkeypatch.setattr(scann, "predict_structures", recorded)
    p = BatchedPredictor(scann, max_batch=16, window_ms=200.0, warmup_shapes=[])
    results, errors = {}, {}

    def call(name):
        try:
            results[name] = p.predict([Structure(*MOLS[name])])
        except Exception as e:
            errors[name] = e

    try:
        workers = [threading.Thread(target=call, args=(n,)) for n in ("water", "carbon", "co")]
        for th in workers:
            th.start()
        for th in workers:
            th.join(60)
    finally:
        p.close()
    assert set(results) == {"water", "co"} and set(errors) == {"carbon"}
    assert "injected" in str(errors["carbon"])
    assert threads and set(threads) == {"scann-device"}
    assert results["water"][0][0] == pytest.approx(
        predict([WATER])[0][0], rel=1e-6)
