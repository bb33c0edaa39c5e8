"""The PyTorch Philox4x32-10 of ``scann_tpu_torch/ops/dropout.py`` (which
``csrc/philox.cuh`` mirrors bit for bit; the card compares the two through
the kernels in ``chip_smoke.py``) and the dropout masks drawn from it."""

import numpy as np
import pytest
import torch

from scann_tpu_torch.ops.dropout import (
    dropout_mask,
    keep_scale,
    keep_threshold,
    make_dropout_masks,
    philox4x32_10,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("ctr,key,want", [
    # Random123's known answers for philox4x32_10 (kat_vectors)
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_torch_philox_known_answers(ctr, key, want):
    got = philox4x32_10(*ctr, *key)
    assert tuple(int(w) for w in got) == want


def test_torch_philox_vectorized_matches_scalar():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 2 ** 32, size=(4, 16), dtype=np.int64)
    k = rng.integers(0, 2 ** 32, size=(2, 16), dtype=np.int64)
    vec = philox4x32_10(*[torch.from_numpy(x) for x in c], *[torch.from_numpy(x) for x in k])
    for i in range(16):
        one = philox4x32_10(*[int(x[i]) for x in c], *[int(x[i]) for x in k])
        assert [int(v[i]) for v in vec] == [int(w) for w in one]


def test_torch_mask_element_layout():
    """Element e of stream s of molecule mol is word e % 4 of Philox at
    counter (e // 4, s, 0, 0), key (seed, mol), kept below the threshold."""
    seed, rate, D = 1234, 0.1, 12
    mol = torch.tensor([7, 8])
    mask = dropout_mask(seed, mol, 3, (5, D), rate)
    assert mask.shape == (2, 5, D)
    for b, m, d in [(0, 0, 0), (1, 4, 11), (0, 2, 5), (1, 3, 2)]:
        e = m * D + d
        word = int(philox4x32_10(e // 4, 3, 0, 0, seed, int(mol[b]))[e % 4])
        want = keep_scale(rate) if word < keep_threshold(rate) else 0.0
        assert float(mask[b, m, d]) == want


def test_torch_keep_threshold_and_scale():
    assert keep_threshold(0.1) == int(0.9 * (2 ** 32 - 1))
    assert keep_scale(0.1) == float(np.float32(1 / 0.9))
    m = make_dropout_masks(5, 0, 8, 32, 16, 128, 8, 2, 0.1, 0.05)
    assert set(torch.unique(m.embed).tolist()) == {0.0, keep_scale(0.1)}
    assert abs(float((m.embed == 0).float().mean()) - 0.1) < 0.01
    assert abs(float((m.attn[1] == 0).float().mean()) - 0.05) < 0.01


def test_torch_masks_do_not_depend_on_batch_tiling():
    """A molecule's masks depend on (seed, its global index, stream) only:
    drawn for the whole batch or for any slice of it, they agree."""
    whole = make_dropout_masks(99, 0, 6, 12, 6, 32, 4, 3, 0.1, 0.05)
    for base, size in [(0, 1), (1, 2), (3, 3)]:
        part = make_dropout_masks(99, base, size, 12, 6, 32, 4, 3, 0.1, 0.05)
        sl = slice(base, base + size)
        assert torch.equal(part.embed, whole.embed[sl])
        for l in range(3):
            assert torch.equal(part.layers[l], whole.layers[l][sl])
            assert torch.equal(part.attn[l], whole.attn[l][sl])
    other = make_dropout_masks(100, 0, 6, 12, 6, 32, 4, 3, 0.1, 0.05)
    assert not torch.equal(other.embed, whole.embed)
    assert not torch.equal(whole.layers[0], whole.layers[1])
    assert make_dropout_masks(99, 0, 6, 12, 6, 32, 4, 3, 0.1).attn is None
