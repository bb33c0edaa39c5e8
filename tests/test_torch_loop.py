"""The PyTorch port's crystal loop forward against the JAX package on the
CPU, in float32: the port's ``loop_scann_forward`` on CPU tensors (its plain
version) against the JAX Pallas loop kernel in interpret mode, on the same
flax parameters (moved with ``params_from_jax``) and the same seeded inputs;
the crystal golden fixtures through the port's API; the kernel's gate; and
the plain version's dropout."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import jit_init_vars, make_synthetic_batch
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.kernels.scann_loop import loop_scann_forward as jax_loop_forward
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu_torch.api import Scann
from scann_tpu_torch.compat import load_h5_params, params_from_jax
from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.models import init_params, scann_forward
from test_torch_golden import load_case

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6          # tests/test_loop_kernels.py's own limits
SMALL = dict(n_atoms=10, embedding_dim=16, local_dim=32, num_head=4, global_dim=32,
             dense_out=16)
MP2018 = ModelConfig(n_atoms=95, embedding_dim=128, n_attention=9, gaussian_d=6.0)
PTGP = ModelConfig(n_atoms=80, n_attention=11, use_ring=True, g_update=False)


def _torch_inputs(inputs):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}


@pytest.mark.parametrize("g_update,ga_norm,ring,cgcnn,layers", [
    (False, False, False, False, 3),
    (True, True, False, False, 2),
    (False, True, True, False, 2),
    (True, True, False, True, 2),
])
def test_torch_loop_forward_matches_jax_loop_kernel(rng, g_update, ga_norm, ring, cgcnn, layers):
    kw = dict(SMALL, n_attention=layers, g_update=g_update, use_ga_norm=ga_norm,
              use_ring=ring, feature="cgcnn" if cgcnn else "atomic")
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    inputs = make_synthetic_batch(rng, B=3, M=12, N=6, use_ring=ring, cgcnn=cgcnn)
    jparams = jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(0), inputs)
    want_p, want_g = jax_loop_forward(jparams, inputs, jcfg, interpret=True)
    tparams = params_from_jax(jax.device_get(jparams), tcfg)
    with torch.no_grad():
        pred, ga = kloop.loop_scann_forward(tparams, _torch_inputs(inputs), tcfg)
    assert pred.shape == (3, 1) and ga.shape == (3, 12, 1)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_p), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(want_g), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["scann_plus_mp2018full", "scann_plus_ptgp11"])
def test_torch_crystal_golden_through_api(name):
    """The two published crystal checkpoints, through ``Scann.forward_eval``
    on the CPU, against the reference TF graph's outputs."""
    cfm, target, inputs, data, h5 = load_case(name)
    scann = Scann(ScannConfig(model=cfm, hyper=HyperConfig(target=target)), device="cpu")
    scann.load_params(load_h5_params(h5, cfm))
    pred, ga = scann.forward_eval(scann.params, inputs)
    np.testing.assert_allclose(pred.numpy(), data["prediction"], rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(ga.numpy(), data["ga_score"], rtol=1e-4, atol=2e-5)
    M, N = inputs["atomic"].shape[1], inputs["neighbors"].shape[2]
    kloop.check_supported(cfm, M, N)     # the loop kernel takes the fixture's shape


@pytest.mark.parametrize("cfm,M,N", [(MP2018, 96, 32), (PTGP, 128, 32), (MP2018, 192, 32)])
def test_torch_loop_gate_accepts_crystal_shapes(cfm, M, N):
    kloop.check_supported(cfm, M, N)
    assert kloop.refusal(cfm, M, N) is None and kloop.supports_loop(cfm)
    assert "loop kernel" in kfwd.refusal(cfm, M, N)   # too large for the molecule kernel
    chunk_atoms, atom_block, abuf, nbytes = kloop.loop_memory_plan(cfm, M, N)
    assert nbytes <= kfwd.MAX_SHARED_BYTES
    assert chunk_atoms * N <= 64 and 1 <= atom_block <= 32
    assert abuf >= chunk_atoms * N * 2 * cfm.local_dim


def test_torch_loop_gate_refuses():
    # past the wide and tall plans' readout vectors (N > 64 and N <= 64):
    # neither keeps resident centers, so both take M into the thousands
    with pytest.raises(NotImplementedError, match="per-layer kernel"):
        kloop.check_supported(MP2018, 30000, 96)
    assert kloop.refusal(MP2018, 512, 96) is None
    assert "readout's vectors" in kloop.refusal(MP2018, 30000, 96)
    assert "readout's vectors" in kloop.refusal(MP2018, 30000, 32)
    with pytest.raises(NotImplementedError, match="use_attn_norm"):
        kloop.check_supported(dataclasses.replace(MP2018, use_attn_norm=False), 96, 32)
    assert not kloop.supports_loop(dataclasses.replace(MP2018, use_attn_norm=False))
    # the bf16 operand mode is taken; another dtype is refused
    assert kloop.refusal(dataclasses.replace(MP2018, dtype="bfloat16"), 96, 32) is None
    with pytest.raises(NotImplementedError, match="float16"):
        kloop.check_supported(dataclasses.replace(MP2018, dtype="float16"), 96, 32)
    with pytest.raises(NotImplementedError, match="sizes"):
        kloop.check_supported(MP2018, 96, 264)
    # packed slots: at most MAX_SEGMENTS segments a slot, within the plan
    assert kloop.refusal(MP2018, 96, 32, 8) is None
    with pytest.raises(NotImplementedError, match="pack_max_segments"):
        kloop.check_supported(MP2018, 96, 32, kfwd.MAX_SEGMENTS + 1)
    # the per-segment vectors fit beside the chunk buffers up to the gate's edge
    assert kloop.max_segments(MP2018, 237, 32) == kfwd.MAX_SEGMENTS


def test_torch_loop_wrapper_refuses_packed_and_cpu_launch(rng):
    cfm = ModelConfig(**SMALL, n_attention=2)
    inputs = _torch_inputs(make_synthetic_batch(rng, B=2, M=12, N=6))
    params = init_params(cfm, torch.Generator().manual_seed(0))
    seg = torch.zeros(2, 12, kfwd.MAX_SEGMENTS + 1)
    seg[:, :, 0] = 1.0
    with pytest.raises(NotImplementedError, match="pack_max_segments"):
        kloop.loop_scann_forward(params, dict(inputs, segment_onehot=seg), cfm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kloop.launch_loop_forward(kfwd.pack_params(params, cfm), inputs, cfm)
    assert kloop.launch_loop_forward.launches == 0


@pytest.mark.parametrize("use_drop", [False, True])
def test_torch_loop_plain_version_dropout_is_the_eager_training_forward(rng, use_drop):
    """At a rate above 0 the plain version is the eager model handed the
    Philox masks of ``ops.dropout`` (attention dropout under ``use_drop``)."""
    cfm = ModelConfig(**SMALL, n_attention=2, use_drop=use_drop)
    inputs = _torch_inputs(make_synthetic_batch(rng, B=3, M=12, N=6))
    params = init_params(cfm, torch.Generator().manual_seed(1))
    masks = kfwd.dropout_masks_for(cfm, inputs, 0.1, 7)
    assert (masks.attn is not None) == use_drop
    with torch.no_grad():
        want_p, want_g = scann_forward(params, inputs, cfm, masks=masks)
        pred, ga = kloop.loop_scann_forward(params, inputs, cfm, dropout_rate=0.1,
                                            dropout_seed=7)
        det_p, _ = kloop.loop_scann_forward(params, inputs, cfm)
        other, _ = kloop.loop_scann_forward(params, inputs, cfm, dropout_rate=0.1,
                                            dropout_seed=8)
    assert torch.equal(pred, want_p) and torch.equal(ga, want_g)
    assert not torch.allclose(pred, det_p) and not torch.allclose(pred, other)


def test_torch_loop_forward_flops_crystal_batches():
    """The counts the kernel's bounds are computed from: 1.849e11 FLOP per
    MP2018 batch (B=64, M=96, N=32, L=9), 1.205e11 per Pt/graphene batch."""
    assert kloop.loop_forward_flops(MP2018, 64, 96, 32) == pytest.approx(1.849e11, rel=1e-3)
    assert kloop.loop_forward_flops(PTGP, 64, 128, 32) == pytest.approx(1.205e11, rel=1e-3)


@pytest.mark.parametrize("M_,N_,ok", [(96, 32, True), (232, 32, True), (237, 32, True),
                                      (238, 32, False), (232, 64, True), (237, 64, True)])
def test_torch_loop_forward_plan_keeps_its_gate(M_, N_, ok):
    """The narrow plan of the tensor-core loop forward still takes M = 232 at
    N = 32 (and N up to 64 there), with its atom blocks; one past its own
    edge, M = 238, is the first tall shape: the tall build (centers in
    global memory) takes it with atom blocks of 32 again and two chunk
    operand buffers (``l2_memory_plan``)."""
    chunk_atoms, block, work, nbytes = kloop.loop_memory_plan(MP2018, M_, N_)
    assert kloop.refusal(MP2018, M_, N_) is None
    assert (nbytes <= kfwd.MAX_SHARED_BYTES) == ok and kloop.is_tall(MP2018, M_, N_) != ok
    assert chunk_atoms * N_ <= 64 and chunk_atoms <= block
    assert block == (32 if M_ <= 189 else 16 if M_ <= 221 else 8)
    assert kloop.forward_plan(MP2018, M_, N_) == (
        (chunk_atoms, block, work, nbytes) if ok
        else kloop.loop_memory_plan(MP2018, M_, N_, tall=True))
    if not ok:
        tall = kloop.forward_plan(MP2018, M_, N_)
        assert tall == kloop.l2_memory_plan(MP2018, M_, N_)[:4]
        assert tall[:2] == (chunk_atoms, 32) and tall[3] == 4 * (2 * 32 * (128 + 4) + tall[2])


def test_torch_molecule_forward_plan_keeps_its_gate():
    """#1 still takes every M up to 64 at N up to 64, and refuses M = 65."""
    for N_ in (16, 32, 64):
        chunk_atoms, work, nbytes = kfwd.shared_memory_plan(ModelConfig(), 64, N_)
        assert nbytes <= kfwd.MAX_SHARED_BYTES and chunk_atoms * N_ <= 64
        assert kfwd.refusal(ModelConfig(), 64, N_) is None
    assert "loop kernel" in kfwd.refusal(ModelConfig(), 65, 16)
    # the QM9 bucket: four atoms (64 rows) per chunk
    assert kfwd.shared_memory_plan(ModelConfig(), 32, 16)[0] == 4


def test_torch_forward_plans_match_cuda_sources():
    """``shared_memory_plan`` and ``loop_memory_plan`` mirror ``make_plan`` of
    ``csrc/scann_forward.cu`` and ``csrc/scann_loop.cu`` (whose launchers also
    refuse a work size other than their own), and the chunk buffers of
    ``csrc/scann_forward_common.cuh`` have the padded strides."""
    from scann_tpu_torch.kernels import _build

    src = {}
    for name in ("scann_forward", "scann_loop", "scann_forward_common"):
        ext = ".cuh" if name.endswith("common") else ".cu"
        with open(f"{_build.SRC_DIR}/{name}{ext}") as f:
            src[name] = f.read()
    assert "return rows * (2 * D + 4) + rows * (D + 4) + round4(rows * H);" in \
        src["scann_forward_common"]
    for name in ("scann_forward", "scann_loop"):
        assert "if (a.abuf_floats != plan.work) return kErrShape;" in src[name]
    fwd = src["scann_forward"][src["scann_forward"].index("inline Plan make_plan"):]
    assert "p.ldm = (a.D > a.G ? a.D : a.G) + 4;" in fwd
    assert "p.total = p.offMisc + 2 * p.ldm + round4(a.M) + round4(a.O);" in fwd
    loop = src["scann_loop"][src["scann_loop"].index("inline Plan make_plan"):]
    for term in ("p.lds = p.wd + 4;", "const int residual = AB * p.lds;",
                 "const int readout = AB * p.wd + 2 * p.wd + 2 * round4(a.M) + round4(a.O);",
                 "p.total = p.offWork + w;"):
        assert term in loop
    D, H, wd = 128, 8, 128
    assert kfwd.forward_chunk_floats(64, D, H) == 64 * (2 * D + 4) + 64 * (D + 4) + 64 * H
    # the whole plans at the QM9 and MP2018 buckets, term by term
    ldm = wd + 4
    assert kfwd.shared_memory_plan(ModelConfig(), 32, 16) == (
        4, 25600, 4 * (3 * 32 * ldm + 25600 + 2 * ldm + 32 + 128))
    assert kloop.loop_memory_plan(MP2018, 96, 32) == (
        2, 32, 25600, 4 * (96 * wd + 2 * 32 * (wd + 4) + 25600))
    assert (D + 4) % 32 == 4 and (2 * D + 4) % 32 == 4      # conflict-free fragment reads


@pytest.mark.parametrize("B_,C", [(1, 4), (20, 4), (28, 4), (29, 2), (64, 2), (66, 2),
                                  (67, 1), (128, 1)])
def test_torch_loop_forward_cluster_choice(B_, C, monkeypatch):
    """The forward launches the backward's cluster of blocks per structure, a
    function of the batch size alone (a block of either takes a whole SM);
    another C is taken when asked for, and refused outside (1, 2, 4)."""
    assert kloop.cluster_size(B_) == C
    seen = []
    monkeypatch.setattr(kfwd, "call_kernel", lambda *a: seen.append(a[4][-1]))
    cfm = ModelConfig(**SMALL, n_attention=1)
    x = _torch_inputs(make_synthetic_batch(np.random.default_rng(0), B=B_, M=8, N=4))
    packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0)), cfm)
    kloop._launch(packed, x, cfm, False)
    kloop._launch(packed, x, cfm, False, cluster=1)
    assert seen == [C, 1]
    with pytest.raises(ValueError, match="launches with"):
        kloop._launch(packed, x, cfm, False, cluster=3)
    scratch = kloop.loop_forward_scratch(cfm, B_ + 1, 8, 4, "cpu")
    with pytest.raises(ValueError, match="scratch"):
        kloop._launch(packed, x, cfm, False, scratch=scratch)


def test_torch_loop_forward_bytes_count_the_geometry_round_trips():
    """#3's bound counts the SCANN+ geometry scratch that does not fit L2:
    written by the embedding, read by each of 9 layers and written back by 8
    (1.81 GB at the MP2018 batch, ~0.54 ms at 3.35 TB/s, under the 2.76 ms of
    its operations); SCANN keeps none."""
    nbytes = kloop.loop_forward_bytes(MP2018, 64, 96, 32)
    assert nbytes == 18 * 64 * 96 * 32 * 128 * 4
    assert 1e3 * nbytes / 3.35e12 < 1e3 * kloop.loop_forward_flops(MP2018, 64, 96, 32) / 67e12
    assert kloop.loop_forward_bytes(PTGP, 64, 128, 32) == 0
