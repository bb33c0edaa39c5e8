"""Structure packing in the PyTorch port (``scann_tpu_torch/data/packing.py``,
the segmented GA readout, the segment mode of the four whole-model kernels'
plain versions, the trainer and ``Scann``) against the JAX package on the
CPU, in float32: the same host arrays element for element, the same packed
forward as ``ScannModel`` (rtol 1e-5 / atol 1e-6), per structure the same as
the unpacked forward (rtol 2e-5 / atol 2e-6, as ``tests/test_packing.py``),
and the JAX kernels in interpret mode at ``n_segments > 0``: pred and ga at
rtol 1e-5 / atol 1e-6, each gradient within 2e-5 x max |reference|. Inputs
come from a numpy seed; every packed batch carries at least one empty
segment."""

import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import jit_apply, jit_init_vars, make_synthetic_batch
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.data import packing as jpacking
from scann_tpu.data.pipeline import load_dataset as jax_load_dataset
from scann_tpu.kernels.scann_backward import fused_scann_grad as jax_fused_grad
from scann_tpu.kernels.scann_backward import fused_scann_train_grads as jax_train_grads
from scann_tpu.kernels.scann_forward import fused_scann_forward as jax_fused_forward
from scann_tpu.kernels.scann_loop import loop_scann_forward as jax_loop_forward
from scann_tpu.kernels.scann_loop import loop_scann_grad as jax_loop_grad
from scann_tpu.kernels.scann_loop import loop_scann_train_grads as jax_loop_train_grads
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu_torch.api import Scann
from scann_tpu_torch.compat import params_from_jax
from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig, TpuConfig
from scann_tpu_torch.data import packing
from scann_tpu_torch.data.pipeline import load_dataset, pack_dataset
from scann_tpu_torch.data.synthetic import make_synthetic_dataset
from scann_tpu_torch.kernels import _build
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.models.scann import init_params, scann_forward
from scann_tpu_torch.ops import attention
from scann_tpu_torch.ops.attention import segment_ids
from scann_tpu_torch.train import loop as train_loop

torch.set_num_threads(1)

SMALL = dict(n_atoms=10, embedding_dim=16, n_attention=2, local_dim=16, num_head=4,
             global_dim=16, dense_out=16)
LOOP_SMALL = dict(SMALL, local_dim=32, global_dim=32)   # the loop kernels take K <= D
GRAD_TOL = 2e-5
QM9 = ModelConfig()
MP2018 = ModelConfig(n_atoms=95, embedding_dim=128, n_attention=9)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_packing_data")
    e, n = make_synthetic_dataset(str(root), n_structures=40, min_atoms=4, max_atoms=14, seed=3)
    return load_dataset(e, n, target="homo"), jax_load_dataset(e, n, target="homo")


def _assert_same_packing(got, want):
    assert set(got.inputs) == set(want.inputs)
    for k, v in want.inputs.items():
        assert got.inputs[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got.inputs[k], v, err_msg=k)
    for f in ("targets", "indices"):
        assert getattr(got, f).dtype == getattr(want, f).dtype
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


# --- host arrays --------------------------------------------------------------

@pytest.mark.parametrize("cap,max_seg,kind", [(32, 4, 0), (48, 8, 1), (96, 8, 2)])
def test_torch_plan_slots_matches_jax(cap, max_seg, kind):
    rng = np.random.default_rng(cap)
    counts = [rng.integers(3, 30, 500), np.minimum(cap, 1 + rng.poisson(cap // 6, 300)),
              np.maximum(1, cap - rng.integers(0, 3, 200))][kind]
    got = packing.plan_slots(counts, cap, max_seg)
    want = jpacking.plan_slots(counts, cap, max_seg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="capacity"):
        packing.plan_slots(np.array([4, cap + 1]), cap)


def test_torch_packed_slot_batch_matches_jax():
    for args in [(128, 1000, 1600), (131, 1000, 1600), (8, 1000, 1600), (1, 100, 800),
                 (131, 1000, 1600, 8), (6, 1000, 1600, 8), (128, 5310, 10000), (64, 37, 120)]:
        assert packing.packed_slot_batch(*args) == jpacking.packed_slot_batch(*args), args


@pytest.mark.parametrize("g_update,feature,capacity,pin", [
    (True, "atomic", 16, False), (False, "cgcnn", None, False), (True, "atomic", 24, True)])
def test_torch_pack_dataset_slots_matches_jax(dataset, g_update, feature, capacity, pin):
    (records, neighbors), (jrecords, jneighbors) = dataset
    kw = dict(g_update=g_update, feature=feature, capacity=capacity, max_segments=4,
              converter=1000.0)
    if pin:
        kw.update(neighbors_capacity=24, segments_capacity=6,
                  orig_indices=np.arange(100, 100 + len(records)))
    got = packing.pack_dataset_slots(records, neighbors, **kw)
    want = jpacking.pack_dataset_slots(jrecords, jneighbors, **kw)
    _assert_same_packing(got, want)
    assert (got.num_structures, got.num_slots, got.num_segments, got.shape, got.occupancy) == (
        want.num_structures, want.num_slots, want.num_segments, want.shape, want.occupancy)
    preds = np.random.default_rng(0).normal(size=got.targets.shape).astype(np.float32)
    np.testing.assert_array_equal(packing.unpack_predictions(got, preds),
                                  jpacking.unpack_predictions(want, preds))


@pytest.mark.parametrize("ring,cgcnn", [(False, False), (True, True)])
def test_torch_pack_padded_inputs_matches_jax(ring, cgcnn):
    inputs = make_synthetic_batch(np.random.default_rng(5), B=9, M=12, N=6, use_ring=ring,
                                  cgcnn=cgcnn)
    _assert_same_packing(packing.pack_padded_inputs(inputs, max_segments=4),
                         jpacking.pack_padded_inputs(inputs, max_segments=4))
    bad = {k: v.copy() for k, v in inputs.items()}
    bad["atom_mask"][0, 0, 0] = 0.0
    with pytest.raises(ValueError, match="prefix"):
        packing.pack_padded_inputs(bad)


def test_torch_segment_ids_mark_padding():
    p = packing.pack_padded_inputs(make_synthetic_batch(np.random.default_rng(1), B=7, M=8,
                                                        N=4), capacity=16, max_segments=4)
    onehot = p.inputs["segment_onehot"]
    ids = segment_ids(torch.from_numpy(onehot))
    assert ids.dtype == torch.int32 and tuple(ids.shape) == onehot.shape[:2]
    am = p.inputs["atom_mask"][..., 0] > 0
    np.testing.assert_array_equal(ids.numpy()[~am], -1)
    np.testing.assert_array_equal(ids.numpy()[am], onehot.argmax(-1)[am])


# --- packed batches for the model and the kernels -----------------------------

def _packed_batch(seed, B=7, M=8, N=6, capacity=16, ring=False, cgcnn=False):
    """Padded structures packed into slots of ``capacity`` rows, with one
    more segment column than the plan uses: every slot has an empty one."""
    inputs = make_synthetic_batch(np.random.default_rng(seed), B=B, M=M, N=N, use_ring=ring,
                                  cgcnn=cgcnn)
    p = packing.pack_padded_inputs(inputs, capacity=capacity, max_segments=4)
    x = dict(p.inputs)
    slots, S = p.indices.shape
    x["segment_onehot"] = np.concatenate(
        [x["segment_onehot"], np.zeros((slots, capacity, 1), np.float32)], axis=-1)
    x["segment_mask"] = np.concatenate([x["segment_mask"], np.zeros((slots, 1), np.float32)], 1)
    indices = np.concatenate([p.indices, -np.ones((slots, 1), np.int64)], 1)
    return inputs, x, indices


def _models(seed, x, edge=False, mrelu=False, small=SMALL, **kw):
    """(JAX config, port config, JAX variables, port params) on the same
    weights; ``edge`` scales the GA projections until, without ga_norm, the
    softmax sum of a segment with atoms underflows to exactly 0 under the
    slot's max shift, every segment far from f32's underflow threshold
    (its max at least 150 below the slot's, or at most 60)."""
    jcfg, tcfg = JaxModelConfig(**small, **kw), ModelConfig(**small, **kw)
    jvars = jit_init_vars(JaxScannModel(config=jcfg, mrelu_head=mrelu), jax.random.PRNGKey(seed),
                          {k: v for k, v in x.items() if k != "segment_mask"})
    jvars = jax.device_get(jvars)
    if not edge:
        return jcfg, tcfg, jvars, params_from_jax(jvars, tcfg)
    ga = jvars["params"]["global_attention"]
    base = {n: np.asarray(ga[n]["kernel"]) for n in ("query", "key")}
    seg = x["segment_onehot"]
    for scale in np.linspace(2.0, 40.0, 77):
        for n in base:
            ga[n]["kernel"] = base[n] * np.float32(scale)
        tparams = params_from_jax(jvars, tcfg)
        gaps = _segment_max_gaps(tparams, x, tcfg)
        if (gaps < -150).any() and ((gaps < -150) | (gaps > -60)).all():
            return jcfg, tcfg, jvars, tparams
    raise AssertionError("no scale of the GA projections reaches the edge cleanly")


def _segment_max_gaps(tparams, x, tcfg):
    """Each non-empty segment's largest GA score minus the slot's (no
    ga_norm), from the eager model's shifted pre-softmax scores."""
    seen = []
    softmax = attention._SegmentSoftmax.apply

    def spy(z, mask, seg):
        seen.append(z)
        return softmax(z, mask, seg)

    with torch.no_grad(), mock.patch.object(attention._SegmentSoftmax, "apply", spy):
        scann_forward(tparams, _torch(x), tcfg)
    z = seen[0][..., 0].numpy()
    seg = x["segment_onehot"]
    zs = np.where(seg > 0, z[..., None], -np.inf).max(axis=1)   # [B, S]
    return zs[seg.sum(1) > 0]


def _torch(x):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}


def _flat(tree):
    return {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_grads(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                                   atol=GRAD_TOL * (np.abs(w).max() + 1e-8),
                                   err_msg=f"gradient of {k}")


def _assert_edge(tparams, x, tcfg):
    """The batch reaches the zero-denominator edge: a segment with atoms
    whose GA scores are all 0."""
    with torch.no_grad():
        _, ga = scann_forward(tparams, _torch(x), tcfg)
    seg = x["segment_onehot"]
    sums = np.einsum("bms,bm->bs", seg, ga.numpy()[..., 0])
    assert ((seg.sum(1) > 0) & (sums == 0)).any()


@pytest.mark.parametrize("g_update,ga_norm,edge", [(True, True, False), (False, False, False),
                                                   (True, False, True)])
def test_torch_packed_eager_forward_matches_jax_model(g_update, ga_norm, edge):
    _, x, _ = _packed_batch(11)
    jcfg, tcfg, jvars, tparams = _models(0, x, edge, g_update=g_update, use_ga_norm=ga_norm)
    if edge:
        _assert_edge(tparams, x, tcfg)
    want = jit_apply(JaxScannModel(config=jcfg))(jvars, {k: jnp.asarray(v) for k, v in x.items()})
    with torch.no_grad():
        pred, ga = scann_forward(tparams, _torch(x), tcfg)
    assert tuple(pred.shape) == x["segment_mask"].shape
    np.testing.assert_allclose(pred.numpy(), np.asarray(want["property"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ga.numpy(), np.asarray(want["ga_score"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("g_update,ga_norm", [(True, True), (False, False)])
def test_torch_packed_forward_matches_unpacked(dataset, g_update, ga_norm):
    (records, neighbors), _ = dataset
    tcfg = ModelConfig(**dict(SMALL, n_atoms=12), g_update=g_update, use_ga_norm=ga_norm)
    params = init_params(tcfg, torch.Generator().manual_seed(0))
    buckets = pack_dataset(records, neighbors, g_update=g_update)
    packed = packing.pack_dataset_slots(records, neighbors, g_update=g_update, capacity=16,
                                        max_segments=4)
    want, want_ga = np.zeros(len(records), np.float32), {}
    with torch.no_grad():
        for b in buckets:
            pred, ga = scann_forward(params, _torch(b.inputs), tcfg)
            want[b.indices] = pred[:, 0].numpy()
            for r, i in enumerate(b.indices):
                want_ga[int(i)] = ga[r, : int(b.inputs["atom_mask"][r].sum()), 0].numpy()
        pred, ga = scann_forward(params, _torch(packed.inputs), tcfg)
    np.testing.assert_allclose(packing.unpack_predictions(packed, pred.numpy()), want,
                               rtol=2e-5, atol=2e-6)
    seg = packed.inputs["segment_onehot"]
    for s, g in zip(*np.nonzero(packed.indices >= 0)):
        rows = np.nonzero(seg[s, :, g] > 0)[0]
        np.testing.assert_allclose(ga[s, rows, 0].numpy(), want_ga[int(packed.indices[s, g])],
                                   rtol=2e-5, atol=2e-6)


# --- the plain segmented versions of kernels #1-#4 against the JAX kernels ----

@pytest.mark.parametrize("edge", [False, True])
def test_torch_packed_molecule_forward_matches_jax_kernel(edge):
    """#1's plain version at n_segments > 0 (pred [B, S], ga) against
    ``scann_forward.py:_kernel`` in interpret mode, also where a segment's
    softmax sum underflows to 0 (the slot's max shift of
    ``scann_forward.py:395-398``)."""
    _, x, _ = _packed_batch(12)
    kw = dict(g_update=True, use_ga_norm=not edge)
    jcfg, tcfg, jvars, tparams = _models(1, x, edge, **kw)
    if edge:
        _assert_edge(tparams, x, tcfg)
    jx = {k: v for k, v in x.items() if k != "segment_mask"}
    jpred, jga = jax_fused_forward(jvars, jx, jcfg, interpret=True, batch_tile=1)
    pred, ga = kfwd.fused_scann_forward(tparams, _torch(x), tcfg)
    assert tuple(pred.shape) == tuple(jpred.shape) == x["segment_mask"].shape
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ga.numpy(), np.asarray(jga), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("edge,mrelu", [(False, False), (True, True)])
def test_torch_packed_molecule_train_grads_match_jax_kernel(edge, mrelu):
    """#2's plain one-shot version at n_segments > 0: pred [B, S] and the raw
    gradients with the empty segments' residuals zeroed."""
    _, x, _ = _packed_batch(13)
    jcfg, tcfg, jvars, tparams = _models(2, x, edge, mrelu=mrelu, g_update=True,
                                         use_ga_norm=not edge)
    if edge:
        _assert_edge(tparams, x, tcfg)
    y = np.random.default_rng(4).normal(size=x["segment_mask"].shape).astype(np.float32)
    jx = {k: v for k, v in x.items() if k != "segment_mask"}
    jpred, jraw = jax_train_grads(jvars, jx, y, jcfg, mrelu_head=mrelu, interpret=True,
                                  batch_tile=1)
    pred, raw = kbwd.fused_scann_train_grads(tparams, _torch(x), torch.from_numpy(y), tcfg,
                                             mrelu)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5, atol=1e-6)
    _assert_grads(raw, _flat(jraw))


def test_torch_packed_molecule_grad_with_cotangents_matches_jax_kernel():
    _, x, _ = _packed_batch(14, ring=True)
    jcfg, tcfg, jvars, tparams = _models(3, x, g_update=False, use_ga_norm=True,
                                         use_ring=True)
    rng = np.random.default_rng(5)
    ct_pred = rng.normal(size=x["segment_mask"].shape).astype(np.float32)
    ct_ga = rng.normal(size=x["atom_mask"].shape).astype(np.float32)
    jx = {k: v for k, v in x.items() if k != "segment_mask"}
    want = jax_fused_grad(jvars, jx, jcfg, ct_pred, ct_ga, interpret=True, batch_tile=1)
    got = kbwd.fused_scann_grad(tparams, _torch(x), tcfg, torch.from_numpy(ct_pred),
                                torch.from_numpy(ct_ga))
    _assert_grads(got, _flat(want))


def test_torch_packed_loop_forward_matches_jax_kernel():
    """#3's plain version at n_segments > 0 against ``_fwd_kernel`` (one slot
    per program) in interpret mode."""
    _, x, _ = _packed_batch(15, B=6, M=12, N=8, capacity=24)
    jcfg, tcfg, jvars, tparams = _models(4, x, small=LOOP_SMALL, g_update=True,
                                         use_ga_norm=True)
    jx = {k: v for k, v in x.items() if k != "segment_mask"}
    jpred, jga = jax_loop_forward(jvars, jx, jcfg, interpret=True)
    pred, ga = kloop.loop_scann_forward(tparams, _torch(x), tcfg)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ga.numpy(), np.asarray(jga), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["one-shot", "cotangent"])
def test_torch_packed_loop_grads_match_jax_kernel(mode):
    """#4's plain version at n_segments > 0 against ``_bwd_kernel`` in
    interpret mode: one-shot (targets [B, S], empty segments zeroed) and
    cotangent mode."""
    _, x, _ = _packed_batch(16, B=6, M=12, N=8, capacity=24)
    jcfg, tcfg, jvars, tparams = _models(5, x, small=LOOP_SMALL, g_update=mode == "one-shot",
                                         use_ga_norm=True)
    jx = {k: v for k, v in x.items() if k != "segment_mask"}
    rng = np.random.default_rng(6)
    if mode == "one-shot":
        y = rng.normal(size=x["segment_mask"].shape).astype(np.float32)
        jpred, jraw = jax_loop_train_grads(jvars, jx, y, jcfg, interpret=True)
        pred, raw = kloop.loop_scann_train_grads(tparams, _torch(x), torch.from_numpy(y), tcfg)
        np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5, atol=1e-6)
    else:
        ct_pred = rng.normal(size=x["segment_mask"].shape).astype(np.float32)
        ct_ga = rng.normal(size=x["atom_mask"].shape).astype(np.float32)
        jraw = jax_loop_grad(jvars, jx, jcfg, ct_pred, ct_ga, interpret=True)
        raw = kloop.loop_scann_grad(tparams, _torch(x), tcfg, torch.from_numpy(ct_pred),
                                    torch.from_numpy(ct_ga))
    _assert_grads(raw, _flat(jraw))


def test_torch_packed_loop_edge_follows_the_jax_model():
    """At the zero-denominator edge the port's #3 and #4 (plain versions,
    as their kernels) shift by the slot's max like the JAX model and #1/#2:
    the TPU loop kernels shift by each segment's max there, so the JAX model
    is the reference (pred, ga, and the gradient of the masked RMSE)."""
    _, x, _ = _packed_batch(17, B=6, M=12, N=8, capacity=24)
    jcfg, tcfg, jvars, tparams = _models(6, x, edge=True, small=LOOP_SMALL, g_update=True,
                                         use_ga_norm=False)
    _assert_edge(tparams, x, tcfg)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    model = JaxScannModel(config=jcfg)
    want = jit_apply(model)(jvars, jx)
    pred, ga = kloop.loop_scann_forward(tparams, _torch(x), tcfg)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want["property"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ga.numpy(), np.asarray(want["ga_score"]), rtol=1e-5, atol=1e-6)
    y = np.random.default_rng(7).normal(size=x["segment_mask"].shape).astype(np.float32)
    smask = x["segment_mask"]

    def loss(p):
        out = model.apply({"params": p}, jx)
        return 0.5 * jnp.sum(jnp.square((out["property"] - y) * smask))

    jraw = jax.grad(loss)(jvars["params"])
    _, raw = kloop.loop_scann_train_grads(tparams, _torch(x), torch.from_numpy(y), tcfg)
    _assert_grads(raw, _flat(jraw))


# --- plans and routes -----------------------------------------------------------

@pytest.mark.parametrize("cfm,M,N", [(QM9, 32, 16), (QM9, 48, 16), (MP2018, 96, 32),
                                     (MP2018, 226, 32), (MP2018, 96, 16)])
def test_torch_packed_memory_plans_fit(cfm, M, N):
    """Every kernel's plan at every S it accepts fits a block's 232448 bytes,
    S = 0 is the unpacked plan, and the first S beyond its largest is
    refused by its gate."""
    plans = [
        (kfwd.refusal, kfwd.max_segments, lambda S: kfwd.shared_memory_plan(cfm, M, N, S)[2]),
        (kbwd.refusal, kbwd.max_segments, lambda S: kbwd.shared_memory_plan(cfm, M, N, S)[1]),
        (kloop.refusal, kloop.max_segments, lambda S: kloop.loop_memory_plan(cfm, M, N, S)[3]),
        (kloop.backward_refusal, kloop.backward_max_segments,
         lambda S: kloop.loop_backward_memory_plan(cfm, M, N, S)[2]),
    ]
    for refusal, largest, nbytes in plans:
        if refusal(cfm, M, N) is not None:
            continue
        top = largest(cfm, M, N)
        assert top >= 8   # pack_max_segments' default fits every shape the kernels take
        for S in range(0, top + 1):
            assert nbytes(S) <= kfwd.MAX_SHARED_BYTES
            assert refusal(cfm, M, N, S) is None
        assert refusal(cfm, M, N, top + 1) is not None


def test_torch_packed_plans_match_cuda_sources():
    """The Python plans' per-segment terms are those of ``make_plan`` in the
    four sources and of ``seg_*_floats`` in ``csrc/scann_common.cuh``, and
    each launcher refuses more than ``kMaxSegments``."""
    with open(os.path.join(_build.SRC_DIR, "scann_common.cuh")) as f:
        common = f.read()
    assert f"constexpr int kMaxSegments = {kfwd.MAX_SEGMENTS};" in common
    assert "return 2 * S * ld + 3 * round4(M) + 2 * round4(S) + round4(O);" in common
    assert "return 3 * S * ld + 5 * round4(M) + 4 * round4(S) + 3 * round4(O);" in common
    assert kfwd.seg_forward_floats(8, 132, 48, 128) == 2 * 8 * 132 + 3 * 48 + 2 * 8 + 128
    assert kfwd.seg_backward_floats(8, 128, 30, 128) == 3 * 8 * 128 + 5 * 32 + 4 * 8 + 3 * 128
    terms = {
        "scann_forward": "if (a.S) p.total = p.offMisc + seg_forward_floats(a.S, p.ldm, a.M, a.O);",
        "scann_loop": "const int seg_readout = AB * p.wd + seg_forward_floats(a.S, p.wd, a.M, a.O);",
        "scann_backward": "const int seg_readout = 5 * p.MW + seg_backward_floats(a.S, p.wd, a.M, a.O);",
        "scann_loop_backward": "const int seg_readout = p.ABW + seg_backward_floats(a.S, p.wd, a.M, a.O);",
    }
    for name, term in terms.items():
        with open(_build.source_files(name)[0]) as f:
            src = f.read()
        assert term in src[src.index("inline Plan make_plan"):src.index("__global__")], name
        assert "if (a.S < 0 || a.S > kMaxSegments || (a.S > 0) != (a.seg != nullptr)) " \
               "return kErrShape;" in src, name
    ldm, wd = 132, 128
    assert kfwd.shared_memory_plan(QM9, 48, 16, 8) == (
        4, 25600, 4 * (3 * 48 * ldm + 25600 + kfwd.seg_forward_floats(8, ldm, 48, 128)))


@pytest.mark.parametrize("cfm,M,N,eval_route,train_route", [
    (QM9, 48, 16, "fused", "loop"), (QM9, 32, 16, "fused", "fused"),
    (MP2018, 96, 32, "loop", "loop")])
def test_torch_packed_routes(cfm, M, N, eval_route, train_route):
    """The packed recipes' routes at S = 8: QM9 at the flagship's capacity
    48 evaluates by #1 and trains by #4, at the derived 32 trains by #2;
    MP2018-like crystals at 96 take #3 and #4."""
    t = train_loop.Trainer(ScannConfig(model=cfm), device="cpu")
    assert t.eval_route(M, N, 8) == eval_route
    assert t.train_route(M, N, 8) == train_route


# --- training, evaluation and prediction through Scann -------------------------

def _scann_config(tmp_path, data, packed=True, **tpu):
    e, n = data
    return ScannConfig(
        model=ModelConfig(**SMALL),
        hyper=HyperConfig(batch_size=8, scheduler="sgdr", data_energy_path=e, data_nei_path=n,
                          save_path=str(tmp_path / "run"), epochs=2, seed=0),
        tpu=TpuConfig(max_buckets=2, structure_packing=packed, pack_max_segments=4, **tpu))


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_packing_scann")
    return make_synthetic_dataset(str(root), n_structures=40, min_atoms=3, max_atoms=10,
                                  seed=2)


def test_torch_packed_scann_trains_and_predicts_like_buckets(tmp_path, small_data):
    """``Scann`` with ``tpu.structure_packing`` trains (the loss falls),
    evaluates, and its ``predict_data`` (values and GA scores) equals the
    bucketed pipeline's with the same parameters, structure for structure,
    in dataset order."""
    s = Scann(_scann_config(tmp_path / "p", small_data), device="cpu")
    s.prepare_dataset()
    assert all("segment_onehot" in b.inputs for b in s.train_buckets)
    hist = s.train(epochs=3)
    assert hist["loss"][-1] < hist["loss"][0]
    result = s.evaluate()
    assert np.isfinite(result["test_mae"])
    u = Scann(_scann_config(tmp_path / "u", small_data, packed=False), device="cpu")
    u.prepare_dataset()
    u.trainer.load_params(s.params)
    u.config.hyper.target_mean = s.config.hyper.target_mean
    u.config.hyper.target_std = s.config.hyper.target_std
    for split in ("train_buckets", "test_buckets"):
        got, got_ga = s.predict_data(getattr(s, split), with_ga=True)
        want, want_ga = u.predict_data(getattr(u, split), with_ga=True)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
        for g, w in zip(got_ga, want_ga):
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-6)
    whole = Scann(_scann_config(tmp_path / "w", small_data), device="cpu")
    whole.prepare_dataset(split=False)
    whole.trainer.load_params(s.params)
    whole.config.hyper.target_mean = s.config.hyper.target_mean
    whole.config.hyper.target_std = s.config.hyper.target_std
    u.prepare_dataset(split=False)
    np.testing.assert_allclose(whole.predict_data(), u.predict_data(), rtol=2e-5, atol=2e-6)


def test_torch_packed_step_gradient_is_the_masked_rmse(tmp_path, small_data):
    """A packed step's RMSE and gradient divide by the count of valid
    segments: at dropout 0 the scaled raw gradient equals ``jax.grad`` of the
    JAX model's masked RMSE (``loop.py:355-379``) on the same slots."""
    s = Scann(_scann_config(tmp_path, small_data), device="cpu")
    s.prepare_dataset()
    t = s.trainer
    t.init_state(0)
    t.dropout_rate = 0.0
    b = s.train_buckets[0]
    rows = np.arange(min(4, len(b.targets)))
    x = {k: v[rows] for k, v in b.inputs.items()}
    y = b.targets[rows]
    pred, raw = t.raw_grads(train_loop._to_device(x, t.device), torch.from_numpy(y), 0)
    smask = x["segment_mask"]
    n = smask.sum()
    rmse = np.sqrt(np.sum(((pred.numpy() - y) * smask) ** 2) / n)
    got = {k: v * (1.0 / (n * rmse)) for k, v in raw.items()}
    jcfg = JaxModelConfig(**SMALL)
    model = JaxScannModel(config=jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, _jax_tree(t.params))
    jx = {k: jnp.asarray(v) for k, v in x.items()}

    def loss(p):
        out = model.apply({"params": p}, jx)
        err = (out["property"] - y) * smask
        return jnp.sqrt(jnp.sum(jnp.square(err)) / n)

    _assert_grads(got, _flat(jax.grad(loss)(jparams)))


def _jax_tree(params):
    """The port's flat params as the flax tree."""
    tree = {}
    for k, v in params.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().numpy()
    return tree


def test_torch_packing_capacity_override(tmp_path, small_data):
    """``tpu.packing_capacity`` raises the slot capacity (rounded up to the
    atom multiple) and packs denser; a value below the largest structure
    raises as in the JAX package; predictions stay those of the derived
    capacity."""
    s = Scann(_scann_config(tmp_path / "a", small_data, packing_capacity=21), device="cpu")
    s.prepare_dataset(split=False)
    p = s._buckets[0]
    assert p.inputs["atomic"].shape[1] == 24
    s.init_params(0)
    d = Scann(_scann_config(tmp_path / "b", small_data), device="cpu")
    d.prepare_dataset(split=False)
    assert d._buckets[0].inputs["atomic"].shape[1] == 16   # 10 atoms -> 16
    assert p.num_slots < d._buckets[0].num_slots
    d.trainer.load_params(s.params)
    np.testing.assert_allclose(s.predict_data(), d.predict_data(), rtol=2e-5, atol=2e-6)
    bad = Scann(_scann_config(tmp_path / "c", small_data, packing_capacity=8), device="cpu")
    with pytest.raises(ValueError, match="below the dataset's largest"):
        bad.prepare_dataset(split=False)


def test_torch_packed_sgdr_resume_is_exact(tmp_path, small_data):
    """A packed SGDR run stopped after one epoch and resumed equals the
    uninterrupted run bit for bit (params, Adam state, lr and loss)."""
    whole = Scann(_scann_config(tmp_path / "a", small_data), device="cpu")
    whole.prepare_dataset()
    h_whole = whole.train(epochs=3)
    first = Scann(_scann_config(tmp_path / "b", small_data), device="cpu")
    first.prepare_dataset()
    first.train(epochs=1)
    resumed = Scann(_scann_config(tmp_path / "b", small_data), device="cpu")
    resumed.prepare_dataset()
    h_res = resumed.train(epochs=3, resume=True)
    a, b = whole.trainer, resumed.trainer
    assert a.step == b.step > 0
    for d1, d2 in ((a.params, b.params), (a.mu, b.mu), (a.nu, b.nu)):
        assert all(torch.equal(d1[k], d2[k]) for k in d1)
    assert h_res["lr"] == h_whole["lr"][1:] and h_res["loss"] == h_whole["loss"][1:]
    lines = [json.loads(x) for x in open(os.path.join(b.workdir, "metrics.jsonl"))]
    assert [r["epoch"] for r in lines] == [0, 1, 2]


def test_torch_train_cli_accepts_structure_packing(tmp_path, small_data, capsys):
    from scann_tpu_torch.cli import train
    from scann_tpu_torch.config import save_config

    cfg = _scann_config(tmp_path, small_data, packed=False)
    path = tmp_path / "c.yaml"
    save_config(cfg, str(path))
    train.main(["homo", str(path), "--epochs", "1", "--structure-packing", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Packed train split" in out and "Test MAE" in open(
        os.path.join(f"{cfg.hyper.save_path}_homo", "report.txt")).read()
