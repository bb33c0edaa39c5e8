"""Wide neighbour lists in the PyTorch port (kernels #5, #3 and #4 past one
chunk of rows: N up to 256) against the JAX package on the CPU, in float32.

- The port's plain versions against the JAX kernels in interpret mode at
  wide N, on seeded numpy inputs whose neighbour lists are live past one
  chunk and carry masked edges (an atom with every neighbour masked, one
  whose neighbours past the first 32 are masked, one with only its last
  neighbour live): #5 (``_pallas_forward``) at N = 72 and 130, #3
  (``loop_scann_forward``) and #4 (``loop_scann_train_grads``, at dropout
  0.1 with attention dropout on the JAX kernel's own masks) at B = 2, M =
  12, N = 40 and 72, L = 2, SCANN+ and SCANN. Tolerances: rtol 1e-5 / atol
  1e-6, gradients 2e-5 x max.
- ``split_softmax`` and ``split_softmax_backward`` (here), the wide
  kernels' split softmax in PyTorch, against ``torch.softmax`` and its gradient at N
  = 33 ... 256 with the -1e9 mask, an all-masked atom and an all-masked
  sub-chunk included.
- #4's plain version against the JAX kernel past the wide #4's old edge
  (M = 250 at N = 40, one layer at D = 128).
- The gates and routes at wide N, the wide builds' launch arguments (a
  stub in place of the CUDA library) and the plans' terms read from the
  CUDA sources; the wide #4's plan (64-row sub-chunks, no resident
  buffer) for every ``configs/*.yaml``.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scann_tpu.kernels.local_attention as jla
from conftest import jit_apply, jit_init_vars
from scann_tpu.config import ModelConfig as JaxModelConfig
from scann_tpu.kernels import scann_loop as jax_loop
from scann_tpu.models import ScannModel as JaxScannModel
from scann_tpu_torch.compat import params_from_jax
from scann_tpu_torch.config import ModelConfig, ScannConfig
from scann_tpu_torch.kernels import _build
from scann_tpu_torch.kernels import local_attention as kla
from scann_tpu_torch.kernels import scann_backward as kbwd
from scann_tpu_torch.kernels import scann_forward as kfwd
from scann_tpu_torch.kernels import scann_loop as kloop
from scann_tpu_torch.models import init_params
from scann_tpu_torch.train import loop as train_loop
from test_kernels import make_layer_inputs
from test_torch_stash import _interpreted, _jax_masks

torch.set_num_threads(1)

GRAD_TOL = 2e-5
SMALL = dict(n_atoms=10, embedding_dim=16, n_attention=2, local_dim=32, num_head=4,
             global_dim=32, dense_out=16)
WIDE = dict(local_dim=128, num_head=8, global_dim=128, dense_out=128, scale=0.5,
            use_attn_norm=True, use_ga_norm=True)
MP2018 = ModelConfig(n_atoms=95, embedding_dim=128, n_attention=9, g_update=True,
                     gaussian_d=6.0, **WIDE)


def _masked_edges(mask):
    """Structure 0: atom 0 with every neighbour masked, atom 1 with those past
    the first 32 masked (whole sub-chunks of #4, most of #3's and #5's),
    atom 2 with only its last neighbour live."""
    N = mask.shape[2]
    mask[0, 0] = 0.0
    mask[0, 1, 32:] = 0.0
    mask[0, 2] = 0.0
    mask[0, 2, N - 1] = 1.0
    return mask


def _wide_batch(rng, B, M, N, use_ring=False):
    """Valid inputs whose atoms have N/2 to N neighbours (indices repeat, as
    periodic images do), with ``_masked_edges``."""
    counts = rng.integers(M // 2, M + 1, size=B)
    counts[0] = M
    x = {"atomic": np.zeros((B, M), np.int32), "atom_mask": np.zeros((B, M, 1), np.float32),
         "neighbors": np.zeros((B, M, N), np.int32),
         "neighbor_mask": np.zeros((B, M, N), np.float32),
         "neighbor_weight": np.zeros((B, M, N), np.float32),
         "neighbor_distance": np.zeros((B, M, N), np.float32)}
    for b, na in enumerate(counts):
        x["atomic"][b, :na] = rng.integers(1, SMALL["n_atoms"], size=na)
        x["atom_mask"][b, :na, 0] = 1.0
        for m in range(na):
            k = rng.integers(N // 2, N + 1)
            x["neighbors"][b, m, :k] = rng.integers(0, na, size=k)
            x["neighbor_mask"][b, m, :k] = 1.0
            x["neighbor_weight"][b, m, :k] = rng.uniform(0.3, 3.0, size=k)
            x["neighbor_distance"][b, m, :k] = rng.uniform(0.8, 4.0, size=k)
    _masked_edges(x["neighbor_mask"])
    if use_ring:
        x["ring_aromatic"] = (rng.integers(0, 2, size=(B, M, 2)) * x["atom_mask"]
                              ).astype(np.float32)
    return x


# --- #5: one LocalAttention layer -----------------------------------------------------

@pytest.mark.parametrize("N", [72, 130])
@pytest.mark.parametrize("g_update", [True, False])
def test_torch_wide_layer_matches_jax_kernel(N, g_update):
    """The plain layer (what ``fused_local_attention`` runs on CPU tensors)
    against the JAX per-layer kernel in interpret mode at N past one chunk of
    64 rows, masked edges included."""
    rng = np.random.default_rng(N)
    centers, idx, geometry, mask, weight, params = make_layer_inputs(
        rng, B=2, M=10, N=N, D=32, g_update=g_update)
    _masked_edges(mask)
    H, scale = 4, 0.5
    kla.check_supported(32, N, geometry.shape[-1], H, torch.float32)
    jargs = [jnp.asarray(a) for a in (centers, idx, geometry, mask, weight)]
    want_out, want_geo, want_attn = jla._pallas_forward(*jargs, params, H, scale, g_update,
                                                        interpret=True)
    flat = {f"{mod}/{name}": torch.from_numpy(np.asarray(v))
            for mod, leaves in params.items() for name, v in leaves.items()}
    with torch.no_grad():
        out, geo, attn = kla.fused_local_attention(
            *[torch.from_numpy(a) for a in (centers, idx, geometry, mask, weight)], flat, H,
            scale, g_update)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), rtol=1e-5, atol=1e-6)
    if g_update:
        np.testing.assert_allclose(geo.numpy(), np.asarray(want_geo), rtol=1e-5, atol=1e-6)
    # the all-masked atom: a uniform softmax over its N neighbours, as the JAX kernel's
    np.testing.assert_allclose(attn[0, 0].numpy(), np.full((N, H), 1.0 / N), rtol=1e-6)
    assert kla.fused_local_attention.launches == 0


# --- #3 and #4: the whole-model loop kernels ----------------------------------------------

CASES = {"scann+": dict(g_update=True), "scann ring": dict(g_update=False, use_ring=True)}


def _setup(seed, N, dropout=False, **kw):
    jcfg = JaxModelConfig(**SMALL, use_drop=dropout, **kw)
    tcfg = ModelConfig(**SMALL, use_drop=dropout, **kw)
    x = _wide_batch(np.random.default_rng(seed), 2, 12, N, tcfg.use_ring)
    jparams = jax.device_get(jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(seed),
                                           x))
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    return jcfg, tcfg, jparams, params_from_jax(jparams, tcfg), x, tx


def _flat(tree):
    return {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("N", [40, 72])
@pytest.mark.parametrize("case", list(CASES))
def test_torch_wide_loop_forward_matches_jax_kernel(case, N):
    """#3's plain version (``loop_scann_forward`` on CPU tensors) against the
    JAX loop forward in interpret mode at N = 40 and 72 (the port's #3 takes
    72 in its wide build)."""
    jcfg, tcfg, jp, tp, x, tx = _setup(3, N, **CASES[case])
    assert kloop.refusal(tcfg, 12, N) is None and kloop.is_wide_forward(tcfg, N) == (N > 64)
    want_pred, want_ga = jax_loop.loop_scann_forward(jp, x, jcfg, interpret=True)
    with torch.no_grad():
        pred, ga = kloop.loop_scann_forward(tp, tx, tcfg)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ga.numpy(), np.asarray(want_ga), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("N", [40, 72])
@pytest.mark.parametrize("case", list(CASES))
def test_torch_wide_loop_train_grads_match_jax_kernel(case, N, monkeypatch):
    """#4's plain version (``loop_scann_train_grads`` on CPU tensors) against
    the JAX loop backward in interpret mode at N = 40 and 72 (both wide in
    the port's #4), at dropout 0.1 with attention dropout on the JAX
    kernel's own masks (drawn in the TPU interpret mode, as
    ``tests/test_torch_stash.py`` draws them)."""
    rate = 0.1
    jcfg, tcfg, jp, tp, x, tx = _setup(4, N, dropout=True, **CASES[case])
    assert kloop.backward_refusal(tcfg, 12, N) is None and kloop.is_wide_backward(tcfg, N)
    masks = _jax_masks("loop", 42, 2, 12, N, tcfg, rate)
    monkeypatch.setattr(kbwd, "dropout_masks_for", lambda *a, **k: masks)
    y = np.random.default_rng(5).normal(size=(2, 1)).astype(np.float32)
    with _interpreted(rate) as interpret:
        want_pred, want = jax_loop.loop_scann_train_grads(jp, x, y, jcfg, interpret=interpret,
                                                          dropout_rate=rate, dropout_seed=42)
    pred, got = kloop.loop_scann_train_grads(tp, tx, torch.from_numpy(y), tcfg,
                                             dropout_rate=rate, dropout_seed=42)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred).reshape(2, -1), rtol=1e-5,
                               atol=1e-6)
    want = _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                                   atol=GRAD_TOL * (np.abs(w).max() + 1e-8),
                                   err_msg=f"gradient of {k}")


EDGE_M, EDGE_N = 250, 40


def test_torch_wide_loop_train_grads_past_the_old_edge():
    """#4's plain version against the JAX loop backward in interpret mode at
    a wide shape past the wide plan's old edge (M = 244 at N = 40 with the
    resident [M, 128] buffer; the JAX kernel's VMEM takes up to 260 there
    without dropout, 242 with it): one structure, one SCANN+ layer at D = G
    = 128, no dropout. The wide #4 trains this shape now
    (``backward_refusal``)."""
    widths = dict(SMALL, n_attention=1, local_dim=128, num_head=8, global_dim=128)
    jcfg = JaxModelConfig(**widths, g_update=True)
    tcfg = ModelConfig(**widths, g_update=True)
    assert jax_loop.fits_loop_vmem(jcfg, EDGE_M, EDGE_N, training=True)
    assert kloop.backward_refusal(tcfg, EDGE_M, EDGE_N) is None
    assert kloop.backward_library(tcfg, EDGE_M, EDGE_N) == "scann_loop_backward_wide"
    x = _wide_batch(np.random.default_rng(25), 1, EDGE_M, EDGE_N)
    jp = jax.device_get(jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(25), x))
    tp, tx = params_from_jax(jp, tcfg), {k: torch.from_numpy(v) for k, v in x.items()}
    y = np.random.default_rng(5).normal(size=(1, 1)).astype(np.float32)
    want_pred, want = jax_loop.loop_scann_train_grads(jp, x, y, jcfg, interpret=True)
    pred, got = kloop.loop_scann_train_grads(tp, tx, torch.from_numpy(y), tcfg)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred).reshape(1, -1), rtol=1e-5,
                               atol=1e-6)
    want = _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                                   atol=GRAD_TOL * (np.abs(w).max() + 1e-8),
                                   err_msg=f"gradient of {k}")


# --- the split softmax of the wide kernels -----------------------------------------------

def split_softmax(energies: torch.Tensor) -> torch.Tensor:
    """The wide kernels' softmax over an atom's N neighbours (``wide_softmax``
    of ``csrc/scann_mma.cuh``) in PyTorch, operation for operation:
    ``energies`` [..., N] (the masked energies, -1e9 added where the mask
    is 0) -> probabilities. Lane l of a warp holds neighbours l, l + 32,
    ...; the max and the sum run lane by lane in that order (the sum from 0,
    padding lanes adding 0), then across the 32 lanes in the warp's xor tree
    (offsets 16, 8, 4, 2, 1), whose result every lane shares."""
    N = energies.shape[-1]
    lanes = -(-N // 32)
    e = torch.nn.functional.pad(energies, (0, 32 * lanes - N), value=float("-inf"))
    e = e.unflatten(-1, (lanes, 32))                       # [..., j, lane]
    mx = _warp_tree(e.amax(-2), torch.maximum)
    p = torch.exp(e - mx[..., None, :])
    tot = torch.zeros_like(mx)
    for j in range(lanes):                                 # lane by lane, in j order
        tot = tot + p[..., j, :]
    tot = _warp_tree(tot, torch.add)
    return (p / tot[..., None, :]).flatten(-2)[..., :N]


def split_softmax_backward(p: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``wide_softmax_backward`` of ``csrc/scann_mma.cuh`` in PyTorch: p and
    f [..., N] (the attention before dropout and d attention) -> p (f - s),
    s = sum_n p f lane by lane, then across the warp, as ``split_softmax``."""
    N = p.shape[-1]
    lanes = -(-N // 32)
    pf = torch.nn.functional.pad(p * f, (0, 32 * lanes - N)).unflatten(-1, (lanes, 32))
    s = torch.zeros_like(pf[..., 0, :])
    for j in range(lanes):
        s = s + pf[..., j, :]
    s = _warp_tree(s, torch.add)[..., :1]
    return p * (f - s)


def _warp_tree(v: torch.Tensor, op) -> torch.Tensor:
    """A warp's xor butterfly over the last axis of 32 lanes (``warp_sum``,
    ``warp_max``): after offsets 16, 8, 4, 2, 1 every lane holds the same
    value."""
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = op(v, v[..., idx ^ o])
    return v



@pytest.mark.parametrize("N", [33, 65, 96, 128, 256])
def test_torch_wide_softmax_mirror_matches_torch_softmax(N):
    """``split_softmax`` (lanes of 32, each summing its neighbours in order,
    then the warp's xor tree) against ``torch.softmax`` of the same masked
    energies, and ``split_softmax_backward`` against autograd through
    ``torch.softmax``; rows: live, an all-masked atom (a uniform 1/N), a
    wholly masked sub-chunk (neighbours 32-63 of a live atom), only the last
    neighbour live, and large energies."""
    rng = np.random.default_rng(N)
    e = torch.from_numpy(rng.normal(size=(6, N)).astype(np.float32)) * 4.0
    e[5] *= 20.0
    mask = torch.ones(6, N)
    mask[1] = 0.0
    mask[2, 32:64] = 0.0
    mask[3] = 0.0
    mask[3, -1] = 1.0
    energies = e + (1.0 - mask) * -1e9
    p = split_softmax(energies)
    want = torch.softmax(energies, dim=-1)
    torch.testing.assert_close(p, want, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(p[1], torch.full((N,), 1.0 / N), rtol=1e-6, atol=0)
    assert torch.all(p[2, 32:64] == 0) and torch.allclose(p[2].sum(), torch.tensor(1.0))
    assert p[3, -1] == 1.0
    f = torch.from_numpy(rng.normal(size=(6, N)).astype(np.float32))
    leaf = energies.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(torch.softmax(leaf, dim=-1), leaf, f)
    torch.testing.assert_close(split_softmax_backward(p, f), grad, rtol=1e-5, atol=1e-6)


def test_torch_wide_softmax_mirror_sums_lane_by_lane():
    """The mirror's sum is the kernel's order, not a plain sum: lane l adds
    neighbours l, l + 32, ... in order from 0, then the 32 lane sums meet in
    the xor tree. Held bit for bit against that order written out."""
    rng = np.random.default_rng(1)
    e = torch.from_numpy(rng.normal(size=(1, 200)).astype(np.float32)) * 3
    lanes = torch.nn.functional.pad(e, (0, 24), value=float("-inf")).view(7, 32)
    mx = lanes.max()
    p = torch.exp(lanes - mx)
    acc = torch.zeros(32)
    for j in range(7):
        acc = acc + p[j]
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[torch.arange(32) ^ o]
    assert len(set(acc.tolist())) == 1
    want = (p / acc[0]).reshape(-1)[:200]
    assert torch.equal(split_softmax(e)[0], want)



def split_context(p: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """The wide kernels' context (``fwd_atom_wide_keys`` of
    ``csrc/scann_forward_common.cuh``) in PyTorch: p [..., N, H] (the
    attention times the neighbour mask) and keys [..., N, D] -> the context
    [..., D]. Column d (head d // (D / H)) sums p * key over the first half
    of the neighbours, n < ceil(N / 2), in order from 0, and over the second
    half in order (the kernel's two halves of the block's threads), then
    adds the halves, first + second; the caller adds the query after. The
    kernel fuses each multiply-add, so the mirror follows its order, not
    its bits."""
    N, H = p.shape[-2:]
    e = p.repeat_interleave(keys.shape[-1] // H, dim=-1)       # [..., N, D]
    half = (N + 1) // 2
    first = torch.zeros_like(keys[..., 0, :])
    second = torch.zeros_like(first)
    for n in range(half):
        first = first + e[..., n, :] * keys[..., n, :]
    for n in range(half, N):
        second = second + e[..., n, :] * keys[..., n, :]
    return first + second


@pytest.mark.parametrize("N", [65, 81, 96, 130, 256])
@pytest.mark.parametrize("g_update", [True, False])
def test_torch_wide_context_mirror_matches_reference_layer(N, g_update, monkeypatch):
    """The plain layer with the wide kernels' orders in place of
    ``local_attention_core``'s (the softmax lane by lane, ``split_softmax``;
    the context in two halves, ``split_context``; then ctx + query) against
    ``reference_local_attention`` itself, at N past one chunk (an odd one
    included), masked edges included: out, geometry and attention within
    f32 rounding."""
    rng = np.random.default_rng(N)
    centers, idx, geometry, mask, weight, params = make_layer_inputs(
        rng, B=2, M=6, N=N, D=32, g_update=g_update)
    _masked_edges(mask)
    flat = {f"{mod}/{name}": torch.from_numpy(np.asarray(v))
            for mod, leaves in params.items() for name, v in leaves.items()}
    args = (*[torch.from_numpy(a) for a in (centers, idx, geometry, mask, weight)], flat, 4,
            0.5, g_update)
    want = kla.reference_local_attention(*args)

    def wide_core(query, key, value, nmask, num_head, scale, dropout_mask=None):
        B, M, D = query.shape
        hd = D // num_head
        q = query.reshape(B, M, num_head, hd) * float(np.float32(hd) ** np.float32(-scale))
        energy = torch.einsum("bmhd,bmnhd->bhmn", q, key.reshape(B, M, N, num_head, hd))
        attn = split_softmax(energy + (1.0 - nmask[:, None]) * -1e9)
        used = attn.permute(0, 2, 3, 1) * nmask[..., None]          # [B, M, N, H]
        return attn, split_context(used, value)

    monkeypatch.setattr(kla, "local_attention_core", wide_core)
    got = kla.reference_local_attention(*args)
    for g, w in zip(got, want):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    # the all-masked atom: a uniform attention over its N neighbours, as the reference's
    assert torch.allclose(got[2][0, 0], torch.full((N, 4), 1.0 / N))

# --- gates, routes, builds ------------------------------------------------------------------

# MP2018 without the attention LayerNorm: no loop kernel takes it, so it
# trains and evaluates per layer at every shape
NO_NORM = dataclasses.replace(MP2018, use_attn_norm=False)

ROUTES = [
    # (config, M, N, training route, eval route)
    (MP2018, 96, 40, "loop", "fused_or_loop"),
    (MP2018, 80, 96, "loop", "loop"),
    (MP2018, 96, 96, "loop", "loop"),
    (NO_NORM, 240, 96, "per_layer", "per_layer"),
    (NO_NORM, 256, 96, "per_layer", "per_layer"),
    (MP2018, 61, 128, "loop", "loop"),
    (MP2018, 30, 256, "loop", "loop"),
    (dataclasses.replace(MP2018, dtype="bfloat16"), 96, 96, "loop", "loop"),
    (MP2018, 300, 32, "loop", "loop"),
    (MP2018, 573, 16, "loop", "loop"),
    (dataclasses.replace(MP2018, dtype="bfloat16"), 300, 32, "loop", "loop"),
    (MP2018, 240, 96, "loop", "loop"),
    (MP2018, 256, 96, "loop", "loop"),
    (dataclasses.replace(MP2018, dtype="bfloat16"), 240, 96, "loop", "loop"),
]


@pytest.mark.parametrize("cfm,M,N,train,evaluate", ROUTES)
def test_torch_wide_routes(cfm, M, N, train, evaluate):
    """The Trainer's routes at wide N come from the gates alone: MP2018 at
    (96, 40) and (80, 96) trains on #4's wide build, (96, 96) evaluates on
    #3's; (240, 96) and (256, 96) train on #4's wide build and evaluate on
    #3's (neither plan grows with M), and without the attention LayerNorm
    both routes are per layer, #5's wide build taking the layer.
    At a narrow N past the narrow plans, (300, 32) and (573, 16)
    train and evaluate on #4's and #3's tall builds. The bf16 operand mode
    takes the routes of f32 at (96, 96) and (300, 32), #4 in its bf16 wide
    and tall builds. ``shape_libraries`` names the builds those routes
    launch."""
    trainer = train_loop.Trainer(ScannConfig(model=cfm), "cpu", "unused")
    assert trainer.train_route(M, N) == train
    got = trainer.eval_route(M, N)
    assert got == evaluate or (evaluate == "fused_or_loop" and got in ("fused", "loop"))
    if evaluate == "per_layer":
        kla.check_supported(cfm.local_dim, N, cfm.num_gaussian, cfm.num_head, torch.float32)
    libs = trainer.shape_libraries([(M, N, 0)], training=True)
    want = set()
    tall = M > 237     # past both narrow plans at these N
    mode = "_bf16" if cfm.dtype == "bfloat16" else ""
    if train == "loop" and N > kbwd.MAX_CHUNK_ROWS:
        want.add("scann_loop_backward_wide" + mode)
    if train == "loop" and N <= kbwd.MAX_CHUNK_ROWS and tall:
        want.add("scann_loop_backward_tall" + mode)
    if got == "loop" and N > kfwd.MAX_CHUNK_ROWS:
        want.add("scann_loop_wide")
    if got == "loop" and N <= kfwd.MAX_CHUNK_ROWS and tall:
        want.add("scann_loop_tall")
    if got == "per_layer" and N > kla.MAX_CHUNK_ROWS:
        want.add("local_attention_wide")
    assert set(libs) == want
    assert set(libs) <= set(_build.SHAPE_SOURCES)
    if cfm.dtype == "bfloat16":     # the routes and plans of the f32 model
        f32 = train_loop.Trainer(ScannConfig(model=dataclasses.replace(cfm, dtype="float32")),
                                 "cpu", "unused")
        assert (f32.train_route(M, N), f32.eval_route(M, N)) == (train, got)
        assert (kloop.refusal(cfm, M, N) is None) == (got == "loop")
        assert (kloop.backward_refusal(cfm, M, N) is None) == (train == "loop")
        assert kloop.refusal(cfm, M, N) == kloop.refusal(f32.config.model, M, N)
        assert kloop.backward_plan(cfm, M, N) == kloop.backward_plan(f32.config.model, M, N)


def test_torch_wide_gates_at_the_edges():
    """The wide builds stop at N = 256 (``MAX_NEIGHBORS``, the CUDA sources'
    kWideMaxN) in all three kernels; #1 and #2 keep their chunk limits."""
    assert kla.MAX_NEIGHBORS == kfwd.MAX_NEIGHBORS == 256
    for src in ("scann_mma.cuh",):
        with open(f"{_build.SRC_DIR}/{src}") as f:
            assert "constexpr int kWideMaxN = 256;" in f.read()
    kla.check_supported(128, 256, 20, 8, torch.float32)
    with pytest.raises(NotImplementedError, match="sizes"):
        kla.check_supported(128, 257, 20, 8, torch.float32)
    assert kloop.refusal(MP2018, 30, 256) is None and "sizes" in kloop.refusal(MP2018, 30, 257)
    assert kloop.backward_refusal(MP2018, 30, 256) is None
    assert "sizes" in kloop.backward_refusal(MP2018, 30, 257)
    assert "sizes" in kfwd.refusal(MP2018, 32, 65) and kfwd.refusal(MP2018, 32, 64) is None
    assert kbwd.refusal(ModelConfig(), 32, 33) is not None
    b16 = dataclasses.replace(MP2018, dtype="bfloat16")
    assert kloop.refusal(b16, 96, 96) is None and kloop.refusal(b16, 96, 64) is None
    assert kloop.refusal(b16, 30, 256) is None and "sizes" in kloop.refusal(b16, 30, 257)
    assert kloop.backward_refusal(b16, 30, 256) is None
    assert "sizes" in kloop.backward_refusal(b16, 30, 257)


def _stub(monkeypatch):
    """A recorder in place of the CUDA library; the launch counts it moves are
    put back after the test."""
    calls = []
    for launcher in (kla.fused_local_attention, kloop.launch_loop_forward,
                     kloop.launch_loop_backward):
        for name in ("launches", "bf16_launches", "wide_launches", "stash_launches",
                     "bf16_stash_launches"):
            if hasattr(launcher, name):
                monkeypatch.setattr(launcher, name, getattr(launcher, name))

    def stub(library, symbol, dev, tensors, dims, *rest):
        calls.append((library, symbol, tensors, dims))
        out = rest[-1] if len(rest) == 4 else None
        if out is not None:
            out.zero_()

    monkeypatch.setattr(kfwd, "call_kernel", stub)
    monkeypatch.setattr(kbwd, "call_kernel", stub)
    return calls


@pytest.mark.parametrize("N", [32, 48, 96])
def test_torch_wide_launch_arguments(N, monkeypatch):
    """A wide N launches the wide builds: #3 above 64 with its readout rows
    [B, M, 2G] f32 last among its pointers (the atom's keys in shared
    memory at this width), #4 above 32 with the tall
    scratch [B * C, M, G + D] there, its rows of one atom [B * C, 3, N, D]
    right after it in one allocation (both None in the narrow builds), and
    counts ``.wide_launches``; a kept scratch without the rows, or with rows
    that do not follow the tall scratch, is refused at a wide N."""
    calls = _stub(monkeypatch)
    cfm = ModelConfig(**SMALL, g_update=True)
    x = {k: torch.from_numpy(v) for k, v in _wide_batch(np.random.default_rng(0), 2, 12, N)
         .items()}
    packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0), "cpu"), cfm)
    fwd0, bwd0 = kloop.launch_loop_forward.wide_launches, kloop.launch_loop_backward.wide_launches
    kloop._launch(packed, x, cfm, False, 0.0, 0, 0, 2)
    kloop._launch_backward(packed, x, cfm, torch.zeros(2, 1), None, True, cluster=2)
    (lib_f, sym_f, t_f, d_f), (lib_b, sym_b, t_b, d_b) = calls
    wide3, wide4 = N > 64, N > 32
    assert (lib_f, sym_f) == (("scann_loop_wide", "scann_loop_forward_wide") if wide3
                              else ("scann_loop", "scann_loop_forward"))
    assert lib_b == sym_b == ("scann_loop_backward_wide" if wide4 else "scann_loop_backward")
    assert len(t_f) == 52 and len(t_b) == 60
    assert (t_f[-1] is None) == (not wide3) and (t_b[-1] is None) == (not wide4)
    if wide3:
        assert tuple(t_f[-1].shape) == (2, 12, 2 * cfm.global_dim)
        assert t_f[-1].dtype == torch.float32
        assert t_f[-1].untyped_storage().nbytes() == 4 * t_f[-1].numel()
    if wide4:
        homes = t_b[-1]
        assert tuple(homes.shape) == (2 * 2, 12, cfm.global_dim + cfm.local_dim)
        assert homes.dtype == torch.float32
        # the rows of one atom [B * C, 3, N, D] fill the rest of the allocation
        assert homes.storage_offset() == 0
        assert homes.untyped_storage().nbytes() == 4 * (homes.numel()
                                                        + 2 * 2 * 3 * N * cfm.local_dim)
    chunk_atoms = d_f[16]
    assert chunk_atoms == (1 if wide3 else max(1, 64 // N))
    assert kloop.launch_loop_forward.wide_launches - fwd0 == wide3
    assert kloop.launch_loop_backward.wide_launches - bwd0 == wide4
    if wide4:
        narrow = kloop.loop_backward_scratch(packed, cfm, 2, 12, 32, 2)
        kept = kloop.loop_backward_scratch(packed, cfm, 2, 12, N, 2)
        assert narrow["wide_rows"] is None and narrow["tall"] is None
        apart = dict(kept, wide_rows=kept["wide_rows"].clone())
        for bad in (dict(kept, wide_rows=None), apart):
            with pytest.raises(ValueError, match="scratch"):
                kloop._launch_backward(packed, x, cfm, torch.zeros(2, 1), None, True,
                                       scratch=bad, cluster=2)


@pytest.mark.parametrize("N", [64, 96, 200])
def test_torch_wide_layer_launch_arguments(N, monkeypatch):
    """#5 at N past 64 launches ``local_attention_wide`` (f32) or
    ``local_attention_wide_bf16``, with one atom a chunk and the bytes of
    ``wide_block_plan``: on f32 tensors the front, two 64-row operand
    buffers, the index ring and the atom's keys [N, D] (at D = 32 they
    always fit: no key scratch); on bf16 tensors one buffer and the keys in
    the per-block scratch [blocks, N, D] (f32). N = 64 takes the narrow
    plan."""
    calls = _stub(monkeypatch)
    monkeypatch.setattr(kla, "sm_count", lambda dev: 132)
    rng = np.random.default_rng(N)
    centers, idx, geometry, mask, weight, params = make_layer_inputs(rng, B=2, M=20, N=N, D=32)
    flat = {f"{mod}/{name}": torch.from_numpy(np.asarray(v))
            for mod, leaves in params.items() for name, v in leaves.items()}
    t = [torch.from_numpy(a) for a in (centers, idx, geometry, mask, weight)]
    before = kla.fused_local_attention.wide_launches
    for dt in (torch.float32, torch.bfloat16):
        kla._launch(*[a.to(dt) if a.is_floating_point() else a for a in t],
                    {k: v.to(dt) for k, v in flat.items()}, 4, 0.5, True)
    wide = N > 64
    r4 = lambda v: -(-v // 4) * 4
    for (lib, sym, tensors, dims), bf16 in zip(calls, (False, True)):
        plan = kla.make_plan(2, 20, N, 32, 4, True, 132, bf16)
        assert lib == ("local_attention_wide" if wide else "local_attention")
        assert sym == lib + ("_bf16" if bf16 else "")
        assert len(tensors) == 19 and dims[8:] == list(plan)
        ab = plan[0]
        if wide:
            buffers, smem_keys, nbytes = kla.wide_block_plan(ab, N, 32, 4, True, bf16)
            assert (ab, plan[1], buffers, smem_keys) == (1, 1, 1 if bf16 else 2, not bf16)
            front = max(64 * (32 + 4) + r4(N * 4), ab * 36)
            assert plan[2] == nbytes == 4 * (2 * ab * 36 + front + buffers * 64 * (2 * 32 + 4)
                                             + r4(2 * N) + (0 if bf16 else N * 32))
            if bf16:
                keys = tensors[-1]
                assert keys.dtype == torch.float32 and tuple(keys.shape) == (2 * 20, N, 32)
            else:
                assert tensors[-1] is None
        else:
            assert tensors[-1] is None
            chunk = kfwd.forward_chunk_floats(plan[1] * N, 32, 4)
            assert plan[2] == 4 * (2 * ab * 36 + max(chunk, ab * 36))
    assert kla.fused_local_attention.wide_launches - before == 2 * wide


@pytest.mark.parametrize("B,M,N,block", [(1, 48, 96, 1), (8, 96, 96, 2), (64, 96, 96, 16),
                                         (1, 384, 96, 1), (8, 64, 128, 4), (4, 32, 256, 1),
                                         (2, 73, 81, 2), (1, 300, 200, 1)])
def test_torch_wide_layer_plan_fills_the_card(B, M, N, block):
    """The wide #5's plan takes its atom block from ``WIDE_ATOM_BLOCKS`` by
    the waves' cost on the H100's 132 SMs, ceil(blocks / 132) x (20 AB + 3)
    (a block's head costs about 0.15 of an atom), the smaller block where
    two tie: one atom a block for the served (1, 48, 96), 48 blocks (the
    parent's 16 atoms a block gave 3), 2 at (8, 96, 96), 384 blocks (the
    parent: 48), 16 at the eval batch (64, 96, 96). No block costs less, on
    f32 and bf16 tensors alike; every block it may return fits 227 KB."""
    for g_update in (True, False):
        for bf16 in (False, True):
            ab, chunk_atoms, nbytes = kla.make_plan(B, M, N, 128, 8, g_update, 132, bf16)
            blocks = B * -(-M // ab)
            assert (ab, chunk_atoms) == (block, 1)
            assert blocks >= {(1, 48, 96): 48, (8, 96, 96): 132}.get((B, M, N), 1)
            plan = kla.wide_block_plan(ab, N, 128, 8, g_update, bf16)
            assert nbytes == plan[2] <= kla.MAX_SHARED_BYTES
            cost = -(-blocks // 132) * (20 * ab + 3)
            for other in kla.WIDE_ATOM_BLOCKS:     # no block costs less; ties go down
                c = -(-B * -(-M // other) // 132) * (20 * other + 3)
                assert c > cost or (c == cost and other >= ab)
    for n in range(65, 257):
        for D in range(4, 129, 4):
            for ab in kla.WIDE_ATOM_BLOCKS:
                for bf16 in (False, True):
                    assert kla.wide_block_plan(ab, n, D, 1, True, bf16) is not None


@pytest.mark.parametrize("N", [65, 81, 96, 116, 117, 199, 237, 238, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_wide_layer_keys_in_shared_memory_where_the_plan_holds_them(N, dtype, monkeypatch):
    """At one MP2018 layer's width (D = 128, 8 heads) the wide #5 on f32
    tensors keeps an atom's keys in shared memory exactly where its plan
    holds them beside one operand buffer (N <= 237 at one atom a block), a
    second buffer where that fits too (N <= 116), and launches no key
    scratch then; past that it passes the per-block scratch [blocks, N, D]
    (f32) and stages with two buffers. On bf16 tensors the plan is the
    smallest, one buffer and the key scratch at every N, so that the L1 left
    beside it holds the bf16 weights. The layout's offsets keep the keys and
    the buffers 16-byte aligned at an odd N."""
    calls = _stub(monkeypatch)
    monkeypatch.setattr(kla, "sm_count", lambda dev: 132)
    B, M, D, H = 2, 5, 128, 8
    bf16 = dtype == torch.bfloat16
    buffers, smem_keys, nbytes = kla.wide_block_plan(1, N, D, H, True, bf16)
    if bf16:
        assert (buffers, smem_keys) == (1, False)
    else:
        assert smem_keys == (N <= 237) and buffers == (2 if N <= 116 or N > 237 else 1)
    rng = np.random.default_rng(N)
    centers, idx, geometry, mask, weight, params = make_layer_inputs(rng, B=B, M=M, N=N, D=D)
    flat = {f"{mod}/{name}": torch.from_numpy(np.asarray(v)).to(dtype)
            for mod, leaves in params.items() for name, v in leaves.items()}
    kla._launch(*[torch.from_numpy(a).to(dtype) if a.dtype == np.float32 else torch.from_numpy(a)
                  for a in (centers, idx, geometry, mask, weight)], flat, H, 0.5, True)
    ((lib, sym, tensors, dims),) = calls
    assert sym == lib + ("_bf16" if bf16 else "") and dims[8:] == [1, 1, nbytes]
    keys = tensors[-1]
    if smem_keys:
        assert keys is None
    else:
        assert keys.dtype == torch.float32 and tuple(keys.shape) == (B * M, N, D)
    r4 = lambda v: -(-v // 4) * 4
    off_a = max(64 * (D + 4) + r4(N * H), D + 4)
    off_k = off_a + buffers * 64 * (2 * D + 4) + r4(2 * N)
    assert off_a % 4 == 0 and off_k % 4 == 0
    assert nbytes == 4 * (2 * (D + 4) + off_k + (N * D if smem_keys else 0))


def test_torch_wide_plans_match_cuda_sources():
    """The wide plans' terms as the CUDA sources write them: #5's
    (``wide_plan_for``: the front, one or two 64-row operand buffers, the
    index ring, the keys where they fit; ``make_wide_plan``'s atom blocks,
    wave cost and ties), #3's without the
    resident centers (``l2_plan``: the same sub-chunk and energies, and the
    atom's keys [N, D] in shared memory where they fit), and #4's
    wide chunk (a 64-row sub-chunk, the atom's attention and d attention [N,
    H], the dropout mask of the sub-chunk and the d query sum [wd]) without
    the resident buffer; the Python mirrors give the same floats."""
    with open(f"{_build.SRC_DIR}/local_attention.cu") as f:
        layer = f.read()
    for term in ("constexpr int kWideAtomBlocks[] = {16, 8, 4, 2, 1};",
                 "constexpr int kWideAtomCost = 20;", "constexpr int kWideHeadCost = 3;",
                 "const long long cost = (blocks + n_sm - 1) / n_sm * (kWideAtomCost * AB + "
                 "kWideHeadCost);",
                 "const int front = kFwdMaxChunkRows * (D + 4) + round4(N * H);",
                 "p.offA = front > centers ? front : centers;",
                 "p.offI = p.offA + buffers * kFwdMaxChunkRows * (2 * D + 4);",
                 "p.offK = p.offI + round4(2 * N);",
                 "p.total = (g_update ? 2 : 1) * AB * (D + 4) + p.offK + (smem_keys ? N * D : 0);",
                 "// layouts i = 0-3: {smem_keys, buffers} = {1, 2}, {1, 1}, {0, 2}, {0, 1}",
                 "for (int i = bf16 ? 3 : 0; i < 4; ++i) {",
                 "const WidePlan q = wide_plan_for(AB, N, D, H, g_update, i < 2, 2 - (i & 1));",
                 "if (best_cost < 0 || cost <= best_cost) {",
                 "(wide_keys == nullptr) != (plan.smem_keys != 0)"):
        assert term in layer, term
    assert tuple(kla.WIDE_ATOM_BLOCKS) == (16, 8, 4, 2, 1)
    assert (kla.WIDE_ATOM_COST, kla.WIDE_HEAD_COST) == (20, 3)
    with open(f"{_build.SRC_DIR}/scann_loop.cu") as f:
        loop = f.read()
    assert "p.rows = kWide ? kWideRows : a.chunk_atoms * a.N;" in loop
    assert "constexpr int kWideRows = kW32 ? kFwdWideW32Rows : kFwdMaxChunkRows;" in loop
    for term in ("const int att = round4(kWide ? a.N * a.H : p.rows * a.H);",
                 "int front = p.rows * (a.D + 4) + att;",
                 "q.offI = front + (kWide ? kWideBuffers : 2) * p.rows * (2 * a.D + 4);",
                 "q.offK = q.offI + round4(2 * (kWide ? a.N : p.rows)) + 4;",
                 "int w = q.offK + (q.smem_keys ? a.N * a.D : 0);"):
        assert term in loop
    with open(f"{_build.SRC_DIR}/scann_loop_backward.cu") as f:
        bwd = f.read()
    assert "p.rows = kWide ? wide_rows : a.chunk_atoms * a.N;" in bwd
    assert "constexpr int kWideChunkRows = 64;" in bwd
    # up to 128 columns every launch takes make_plan's default, kWideChunkRows
    assert ("  } else {\n    return make_plan<kWide>(a);\n  }" in bwd
            and "const Plan P = build_plan<kWide>(a);" in bwd)
    assert "p.offBlk = kTall || kWide ? 0 : a.M * p.wd;" in bwd
    assert ("const int chunk = kWide ? p.rows * p.lda + 3 * p.rows * p.ldu + "
            "2 * round4(a.N * a.H) +\n                                round4(p.rows * a.H) + p.wd"
            ) in bwd
    for name in _build.WIDE_SOURCES:
        files = _build.source_files(name)
        assert files[1].endswith(name.replace("_wide", "") + ".cu"), files
    r4 = lambda v: -(-v // 4) * 4
    D, H, wd = 128, 8, 128
    for N in (72, 96, 256):
        _, block, work, nbytes = kloop.loop_memory_plan(MP2018, 80, N)
        keys = kloop.l2_memory_plan(MP2018, 80, N)[4]
        # a 64-row sub-chunk's buffers and the energy row, then the index ring
        assert work == (64 * (2 * D + 4) + 64 * (D + 4) + r4(N * H) + r4(2 * N) + 4
                        + (N * D if keys else 0))
        assert keys == (N <= 200) and nbytes == 4 * (2 * block * (wd + 4) + work)
    for N in (40, 96, 256):
        chunk_atoms, block, nbytes = kloop.loop_backward_memory_plan(MP2018, 60, N)
        rows = 64
        chunk = rows * (2 * D + 4) + 3 * rows * (D + 4) + 2 * r4(N * H) + r4(rows * H) + wd
        O = MP2018.dense_out
        work = max(chunk, 5 * block * wd + r4(block), block * 2 * 128 + block * wd,
                   block * wd + 4 * wd + 5 * 60 + 3 * O + 4)
        assert chunk_atoms == 1 and block == (16 if N <= 184 else 8)
        assert nbytes == 4 * (5 * block * wd + work + 8 * 2 * wd + 2 * wd)
    # past the old edge (M * 512 resident bytes: blocks of 4 at (240, 48)) the
    # plan keeps its blocks; the narrow build keeps its resident buffer
    assert kloop.loop_backward_memory_plan(MP2018, 240, 48)[1] == 16
    assert kloop.loop_backward_memory_plan(MP2018, 2000, 184)[1] == 16
    assert kloop.loop_backward_memory_plan(MP2018, 40, 185)[1] == 8
    assert kloop.loop_backward_memory_plan(MP2018, 226, 32)[1] == 8


@pytest.mark.parametrize("name,M,N,S", [
    ("mp2018", 80, 96, 0), ("mp2018", 300, 96, 0), ("mp2018", 1000, 128, 0),
    ("mp2018", 40, 200, 0), ("mp2018", 40, 256, 0), ("mp2018", 3000, 256, 0),
    ("mp2018", 96, 96, 8), ("ptgp", 322, 32, 0), ("ptgp", 573, 16, 0), ("mp2018", 428, 16, 0),
    ("mp2018", 300, 32, 8), ("mp2018", 20000, 32, 0), ("small", 12, 72, 0),
    ("mp2018", 73, 81, 0), ("mp2018", 40, 199, 0), ("ptgp", 300, 21, 0)])
def test_torch_l2_plan_matches_cuda_source(name, M, N, S):
    """``l2_memory_plan``, the Python mirror of ``l2_plan`` and ``make_plan``
    of ``csrc/scann_loop.cu`` for the tall and wide builds, term by term as
    the source writes them: two slots, the front (a chunk's product and
    attention, or the wide atom's energy row, at least the ResidualNorm's
    h2), two chunk operand buffers in the tall build and one 64-row sub-chunk
    in the wide one, the index ring (two slots of a chunk's or an atom's
    neighbour indices) and two mbarriers, and the wide atom's keys [N, D]
    where the plan with them fits (else in L2); the atom block the largest
    that fits."""
    with open(f"{_build.SRC_DIR}/scann_loop.cu") as f:
        loop = f.read()
    plan = loop[loop.index("inline L2Plan l2_plan("):loop.index("inline L2Plan make_l2_plan(")]
    # up to 128 columns kW32 is false: one sub-chunk buffer of 64 rows
    assert "constexpr int kWideRows = kW32 ? kFwdWideW32Rows : kFwdMaxChunkRows;" in loop
    assert "constexpr int kWideBuffers = kW32 ? 2 : 1;" in loop
    for term in ("p.rows = kWide ? kWideRows : a.chunk_atoms * a.N;",
                 "const int att = round4(kWide ? a.N * a.H : p.rows * a.H);",
                 "int front = p.rows * (a.D + 4) + att;",
                 "front = AB * p.lds > front ? AB * p.lds : front;",
                 "q.offA1 = front + p.rows * (2 * a.D + 4);",
                 "q.offI = front + (kWide ? kWideBuffers : 2) * p.rows * (2 * a.D + 4);",
                 "q.offK = q.offI + round4(2 * (kWide ? a.N : p.rows)) + 4;",
                 "int w = q.offK + (q.smem_keys ? a.N * a.D : 0);",
                 "const int readout = AB * p.wd + 2 * p.wd + 2 * round4(a.M) + round4(a.O);",
                 "p.offWork = 2 * AB * p.lds;", "p.total = p.offWork + w;"):
        assert term in plan, term
    make = loop[loop.index("inline L2Plan make_l2_plan("):]
    assert ("const L2Plan q = l2_plan<kWide>(a, true);\n"
            "  if (!kWide || q.p.total * (int)sizeof(float) <= kMaxSharedBytes) return q;\n"
            "  return l2_plan<kWide>(a, false);") in make
    cfm = {"mp2018": MP2018, "ptgp": dataclasses.replace(MP2018, embedding_dim=48,
                                                         use_ring=True, g_update=False),
           "small": ModelConfig(**SMALL)}[name]
    r4 = lambda v: -(-v // 4) * 4
    D, G, O, H = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.num_head
    wd, wide = max(D, G), N > 64
    lde = r4(cfm.embedding_dim + (10 if cfm.use_ring else 0))

    def plan(block, keys):
        ca = 1 if wide else max(1, min(block, 64 // N))
        rows = 64 if wide else ca * N
        front = max(rows * (D + 4) + r4((N if wide else rows) * H), block * (wd + 4))
        w = (front + (1 if wide else 2) * rows * (2 * D + 4) + r4(2 * (N if wide else rows))
             + 4 + (N * D if keys else 0))
        w = max(w, block * lde, block * wd + 2 * wd + 2 * r4(M) + r4(O))
        if S:
            w = max(w, block * wd + kfwd.seg_forward_floats(S, wd, M, O))
        return ca, block, w, 4 * (2 * block * (wd + 4) + w), keys

    tries = [plan(min(b, M), k) for k in ((True, False) if wide else (False,))
             for b in (32, 16, 8)]
    want = next((t for t in tries if t[3] <= kfwd.MAX_SHARED_BYTES), tries[-1])
    assert kloop.l2_memory_plan(cfm, M, N, S) == want
    assert kloop.forward_plan(cfm, M, N, S, tall=not wide) == want[:4]
    # the kernel's own choice of where the keys go, at the atom block chosen
    assert want[4] == (wide and plan(want[1], True)[3] <= kfwd.MAX_SHARED_BYTES)
    keys = kloop.wide_keys_shape_for(cfm, 2, M, N, 3, S)
    assert keys == (None if not wide or want[4] else (6, N, D))


@pytest.mark.parametrize("N", [65, 73, 81, 99, 127, 150, 199, 255, 9, 21, 31])
def test_torch_l2_plan_keeps_the_keys_aligned(N):
    """At an odd N the index ring [2][N] ends 8 bytes off a 16-byte
    boundary; ``l2_plan`` rounds it up to 4 floats, so the wide atom's keys
    after it (written as float4) start on a 16-byte boundary, and the
    mbarriers after the ring on an 8-byte one, at every N and at the atom
    block the plan takes."""
    with open(f"{_build.SRC_DIR}/scann_loop.cu") as f:
        loop = f.read()
    assert "q.offK = q.offI + round4(2 * (kWide ? a.N : p.rows)) + 4;" in loop
    assert "bars = reinterpret_cast<unsigned long long*>(ring + 2 * ring_n);" in loop
    r4 = lambda v: -(-v // 4) * 4
    D, H, wd = MP2018.local_dim, MP2018.num_head, max(MP2018.local_dim, MP2018.global_dim)
    wide = N > 64
    chunk_atoms, block, work, _, keys = kloop.l2_memory_plan(MP2018, 80, N)
    rows = 64 if wide else chunk_atoms * N
    ring = N if wide else rows
    front = max(rows * (D + 4) + r4((N if wide else rows) * H), block * (wd + 4))
    off_i = front + (1 if wide else 2) * rows * (2 * D + 4)
    off_k = off_i + r4(2 * ring) + 4
    work_base = 2 * block * (wd + 4)   # the work region's own offset, in floats
    assert (work_base + off_i) % 4 == 0 and (work_base + off_k) % 4 == 0
    assert (4 * (work_base + off_i) + 4 * 2 * ring) % 8 == 0   # the mbarriers
    assert off_i + 2 * ring + 4 <= off_k   # the ring and the mbarriers fit before the keys
    assert work >= off_k + (N * D if keys else 0)
    assert keys == (wide and N <= 200)


@pytest.mark.parametrize("M", [240, 300, 1000])
def test_torch_wide_gate_takes_m_into_the_thousands(M):
    """Without resident centers the wide #3's plan does not grow with M but
    for the readout's vectors: MP2018 at N = 96 (and 256) evaluates on #3
    at M = 240, 300 and 1000, past the old edge of 235, in f32 and bf16,
    with the same plan as at M = 80; the Trainer's ``eval_route`` sends
    these buckets to "loop" (#3) rather than to the per-layer model."""
    for cfm in (MP2018, dataclasses.replace(MP2018, dtype="bfloat16")):
        for N in (96, 256):
            assert kloop.refusal(cfm, M, N) is None
            assert kloop.forward_plan(cfm, M, N) == kloop.forward_plan(cfm, 80, N)
            assert kloop.forward_library(cfm, M, N) == ("scann_loop_wide",
                                                        "scann_loop_forward_wide")
        trainer = train_loop.Trainer(ScannConfig(model=cfm), "cpu", "unused")
        assert trainer.eval_route(M, 96) == "loop"
        assert tuple(trainer.shape_libraries([(M, 96, 0)], training=False)) == ("scann_loop_wide",)
    assert "readout's vectors" in kloop.refusal(MP2018, 30000, 96)


PAST_EDGE_M, PAST_EDGE_N = 240, 72


@pytest.mark.parametrize("case", list(CASES))
def test_torch_wide_loop_forward_past_the_old_edge(case):
    """#3's plain version (``loop_scann_forward`` on CPU tensors) at a wide
    shape past the wide #3's old edge (M = 235 with the resident centers):
    one structure of 240 atoms, N = 72, one layer at D = G = 128, against
    the JAX model (the JAX loop kernel's VMEM refuses this shape). The wide
    #3 takes it now (``refusal``, ``forward_library``)."""
    widths = dict(SMALL, n_attention=1, local_dim=128, num_head=8, global_dim=128)
    jcfg = JaxModelConfig(**widths, **CASES[case])
    tcfg = ModelConfig(**widths, **CASES[case])
    assert kloop.refusal(tcfg, PAST_EDGE_M, PAST_EDGE_N) is None
    assert kloop.forward_library(tcfg, PAST_EDGE_M, PAST_EDGE_N)[0] == "scann_loop_wide"
    assert not jax_loop.fits_loop_vmem(jcfg, PAST_EDGE_M, PAST_EDGE_N, training=False)
    x = _wide_batch(np.random.default_rng(26), 1, PAST_EDGE_M, PAST_EDGE_N, tcfg.use_ring)
    jp = jax.device_get(jit_init_vars(JaxScannModel(config=jcfg), jax.random.PRNGKey(26), x))
    tp, tx = params_from_jax(jp, tcfg), {k: torch.from_numpy(v) for k, v in x.items()}
    want = jit_apply(JaxScannModel(config=jcfg))(jp, x)
    with torch.no_grad():
        pred, ga = kloop.loop_scann_forward(tp, tx, tcfg)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want["property"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ga.numpy(), np.asarray(want["ga_score"]), rtol=1e-5, atol=1e-6)
    assert kloop.launch_loop_forward.launches == 0


def test_torch_wide_keys_in_l2_follow_the_readout_rows(monkeypatch):
    """Where the wide plan leaves the atom's keys out of shared memory (N =
    256 at D = 128), the launch hands #3 one allocation: the readout rows
    [B, M, 2G] followed by each block's keys [B * C, N, D]; a kept scratch
    whose keys do not follow is refused."""
    calls = _stub(monkeypatch)
    cfm = dataclasses.replace(MP2018, n_attention=1, embedding_dim=8)
    B, M, N = 2, 12, 256
    assert not kloop.l2_memory_plan(cfm, M, N)[4]
    x = {k: torch.from_numpy(v) for k, v in _wide_batch(np.random.default_rng(3), B, M, N)
         .items()}
    packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0), "cpu"), cfm)
    kloop._launch(packed, x, cfm, False, 0.0, 0, 0, 3)
    (_, _, t_f, d_f), = calls
    rows = t_f[-1]
    assert tuple(rows.shape) == (B, M, 2 * cfm.global_dim) and d_f[-1] == 3
    assert rows.untyped_storage().nbytes() == 4 * (rows.numel() + B * 3 * N * cfm.local_dim)
    kept = kloop.loop_forward_scratch(cfm, B, M, N, "cpu", 3)
    assert kept["wide_keys"].data_ptr() == kept["readout"].data_ptr() + 4 * kept["readout"].numel()
    with pytest.raises(ValueError, match="follow"):
        kloop._launch(packed, x, cfm, False, 0.0, 0, 0, 3,
                      dict(kept, wide_keys=kept["wide_keys"].clone()))
    with pytest.raises(ValueError, match="launches with"):
        kloop._launch(packed, x, cfm, False, 0.0, 0, 0, 17)


def _yaml_models():
    """The model block of every ``configs/*.yaml``, by file name."""
    import glob
    import os

    from scann_tpu_torch.config import load_config
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
    return {os.path.basename(p)[:-5]: load_config(p).model
            for p in sorted(glob.glob(os.path.join(root, "*.yaml")))}


YAML_MODELS = _yaml_models()


def _parent_plan(cfm, M, N, S, rows, resident):
    """The loop backward's plan term by term as ``make_plan`` adds it, with
    chunks of ``rows`` rows (narrow: whole atoms up to that many; wide: one
    atom's sub-chunk of that many) and the resident [M, wd] buffer or not."""
    r4 = lambda v: -(-v // 4) * 4
    D, G, O, H = cfm.local_dim, cfm.global_dim, cfm.dense_out, cfm.num_head
    wd = max(D, G)
    lde = r4(cfm.embedding_dim + (10 if cfm.use_ring else 0))
    ldf = r4(kbwd.CGCNN_FEATURES) if cfm.feature == "cgcnn" else 0
    wide = N > 32
    for block in (32, 16, 8, 4) if wide else (32, 16, 8):
        block = min(block, M)
        ca = 1 if wide else max(1, min(block, rows // N))
        chunk = (rows * (2 * D + 4) + 3 * rows * (D + 4) + 2 * r4(N * H) + r4(rows * H) + wd
                 if wide else kbwd.chunk_floats(ca * N, D, H))
        work = max(chunk, 5 * block * wd + r4(block), block * (2 * lde + ldf) + block * wd,
                   block * wd + 4 * wd + 5 * r4(M) + 3 * r4(O) + 4)
        if S:
            work = max(work, block * wd + kfwd.seg_backward_floats(S, wd, M, O))
        floats = (M * wd if resident else 0) + 5 * block * wd + work + 8 * 2 * wd + 2 * wd
        if 4 * floats <= kfwd.MAX_SHARED_BYTES:
            break
    return ca, block, 4 * floats


@pytest.mark.parametrize("N", [40, 48, 64, 96, 128, 192, 256])
@pytest.mark.parametrize("name", sorted(YAML_MODELS))
def test_torch_wide_backward_plans_take_64_rows(name, N):
    """#4's wide plan for every ``configs/*.yaml`` at M from 48 to 2000 and
    S up to ``backward_max_segments``: sub-chunks of 64 rows of one atom and
    no resident buffer, within a block's shared memory with atom blocks of
    16 up to N = 184 and 8 beyond (at D = G = 128), so the gate takes every
    such M; the narrow and tall plans (N = 16 and 32) are the ones they
    were, term by term."""
    cfm = YAML_MODELS[name]
    assert kloop.WIDE_CHUNK_ROWS == 64 and kloop.is_wide_backward(cfm, N)
    for M in (48, 80, 96, 128, 217, 243, 244, 300, 600, 1000, 2000):
        S_max = kloop.backward_max_segments(cfm, M, N)
        assert S_max == kfwd.MAX_SEGMENTS, (M, S_max)
        for S in sorted({0, 1, 8, S_max}):
            plan = kloop.loop_backward_memory_plan(cfm, M, N, S)
            assert plan == _parent_plan(cfm, M, N, S, 64, resident=False), (M, S)
            assert plan == kloop.backward_plan(cfm, M, N, S)
            assert plan[0] == 1 and plan[2] <= kfwd.MAX_SHARED_BYTES, (M, S)
            if max(cfm.local_dim, cfm.global_dim) == 128 and cfm.num_head == 8:
                assert plan[1] == min(16 if N <= 184 else 8, M), (M, S)
            assert kloop.backward_refusal(cfm, M, N, S) is None
        for n in (16, 32):
            assert kloop.loop_backward_memory_plan(cfm, M, n) == _parent_plan(
                cfm, M, n, 0, 32, resident=True)
            assert kloop.loop_backward_memory_plan(cfm, M, n, tall=True) == _parent_plan(
                cfm, M, n, 0, kloop.TALL_CHUNK_ROWS, resident=False)


def _between(text, start, end):
    """The text of ``text`` from the first ``start`` up to the next ``end``."""
    i = text.index(start)
    return text[i:text.index(end, i + len(start))]


def test_torch_wide_row_copy_matches_fwd_chunk():
    """The wide forward's copies of ``fwd_chunk``'s code in
    ``csrc/scann_forward_common.cuh`` (kept apart so that the narrow builds
    compile as they did) are that code, character for character:
    ``fwd_chunk_rows`` is its row part (the geometry update or the filter,
    the LayerNorm of the geometry, the key product) and ``fwd_out_norm``'s
    loop its LayerNorm of ctx + query."""
    with open(f"{_build.SRC_DIR}/scann_forward_common.cuh") as f:
        common = f.read()
    # fwd_chunk's body is fwd_chunk_impl's, whose row products are row_gemm
    # calls (mma_gemm where kW32 is false, mma_gemm_w32 on the planes where
    # it is true); fwd_chunk_rows takes the same kW32 and makes the same calls
    chunk = _between(common, "__device__ __forceinline__ void fwd_chunk_impl(",
                     "\n// The wide form of fwd_chunk")
    rows = _between(common, "__device__ __forceinline__ void fwd_chunk_rows(",
                    "\n// out = LN(ctx + query)")
    norm = _between(common, "__device__ __forceinline__ void fwd_out_norm(",
                    "\n// LocalAttention of one staged chunk")
    body = _between(rows, "  if (a.g_update) {\n", "\n}\n")
    assert body.count("row_gemm<kW32, kBf16>") == 3 and "warp_layer_norm_rows" in body
    assert ("template <bool kBf16 = false, bool kW32 = false, typename T>\n"
            "__device__ __forceinline__ void fwd_chunk_rows(") in common
    assert _between(chunk, "  if (a.g_update) {\n", "  // energies (query * dk)") == body + "\n"
    loop = _between(norm, "  for (int at = warp; at < ca; at += kWarps) {", "\n}\n")
    assert "warp_layer_norm(v, D, w.ln_s, w.ln_b, lane);" in loop
    assert _between(chunk, "  // out = LN(ctx + query), one warp per atom\n",
                    "\n}\n") == "  // out = LN(ctx + query), one warp per atom\n" + loop


@pytest.mark.parametrize("N", [32, 48, 64, 96])
def test_torch_wide_max_clusters_read_the_launched_build(N, monkeypatch):
    """``max_active_forward_clusters`` and ``max_active_clusters`` ask the
    build that a launch at N takes (``forward_library``,
    ``backward_library``: the wide one past 64 and 32 neighbours), with that
    build's plan, and each build exports its own entry (read from the CUDA
    sources)."""
    asked = []

    class Lib:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, symbol):
            def entry(dims, cluster):
                asked.append((self.name, symbol, list(dims), cluster))
                return 7
            return entry

    monkeypatch.setattr(_build, "load_library", Lib)
    assert kloop.max_active_forward_clusters(MP2018, 16, 60, N, 4) == 7
    assert kloop.max_active_clusters(MP2018, 16, 60, N, 4) == 7
    b16 = dataclasses.replace(MP2018, dtype="bfloat16")
    assert kloop.max_active_clusters(b16, 16, 60, N, 2) == 7
    assert kloop.max_active_forward_clusters(b16, 16, 60, N, 2) == 7
    ((lib_f, sym_f, dims_f, _), (lib_b, sym_b, dims_b, _), (lib_16, sym_16, _, _),
     (lib_f16, sym_f16, dims_f16, _)) = asked
    assert (lib_f, sym_f) == ((("scann_loop_wide", "scann_loop_forward_wide_max_clusters"))
                              if N > 64 else ("scann_loop", "scann_loop_forward_max_clusters"))
    assert (lib_b, sym_b) == ((("scann_loop_backward_wide",
                                "scann_loop_backward_wide_max_clusters"))
                              if N > 32 else ("scann_loop_backward",
                                              "scann_loop_backward_max_clusters"))
    # the bf16 builds answer for their own kernels: #4's its own library, #3's
    # its build's bf16 kernel (the operand mode in size 22, as a launch has it)
    assert lib_16 == lib_b + "_bf16" and sym_16 == lib_16 + "_max_clusters"
    assert (lib_f16, sym_f16) == (lib_f, sym_f)
    assert (dims_f[22], dims_f16[22], dims_f[23]) == (0, 1, 4)
    chunk_atoms, block, work, _ = kloop.loop_memory_plan(MP2018, 60, N)
    assert (dims_f[16], dims_f[17], dims_f[20]) == (chunk_atoms, work, block)
    assert dims_b[21] == kloop.loop_backward_memory_plan(MP2018, 60, N)[1]
    with open(f"{_build.SRC_DIR}/scann_loop.cu") as f:
        assert 'extern "C" int SCANN_LOOP_ENTRY(max_clusters)(' in f.read()
    with open(f"{_build.SRC_DIR}/scann_loop_backward.cu") as f:
        bwd = f.read()
    assert "return max_clusters<kBf16Build, kWideBuild>(dims, cluster);" in bwd
    assert 'extern "C" int SCANN_LOOP_BACKWARD_ENTRY(max_clusters)(' in bwd
    for name in ("wide", "wide_bf16", "tall", "tall_bf16", "bf16"):
        assert f"#define SCANN_LOOP_BACKWARD_ENTRY(x) scann_loop_backward_{name}_##x" in bwd
