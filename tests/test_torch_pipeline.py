"""The PyTorch port's dataset pipeline against the JAX package's, on the
CPU: synthetic dataset files, loading, bucketing, splitting and subsets
give identical arrays. The JAX side runs its scipy/Qhull Voronoi path
(``SCANN_TPU_NATIVE_VORONOI=0``), the only one the port has."""

import numpy as np
import pytest

from scann_tpu.data import featurize as jax_featurize
from scann_tpu.data import pipeline as jax_pipeline
from scann_tpu.data import synthetic as jax_synthetic
from scann_tpu_torch.data import featurize, pipeline, synthetic


@pytest.fixture(autouse=True)
def scipy_voronoi(monkeypatch):
    monkeypatch.setenv("SCANN_TPU_NATIVE_VORONOI", "0")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCANN_TPU_NATIVE_VORONOI", "0")
        jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("torch")
        kw = dict(n_structures=36, min_atoms=3, max_atoms=14, seed=5, with_ring=True)
        return (jax_synthetic.make_synthetic_dataset(str(jdir), **kw),
                synthetic.make_synthetic_dataset(str(tdir), **kw))


def test_torch_synthetic_dataset_files_identical(datasets):
    (je, jn), (te, tn) = datasets
    for a, b in ((je, te), (jn, tn)):
        assert open(a, "rb").read() == open(b, "rb").read()
    rec = np.load(te, allow_pickle=True)[0]
    assert featurize.featurize_record(rec) == jax_featurize.featurize_record(rec)
    arr = featurize.as_object_array([[[0, 1]], [[0, 1]]])
    assert arr.shape == (2,) and arr.dtype == object


@pytest.mark.parametrize("g_update,feature,use_ring", [
    (True, "atomic", False), (False, "cgcnn", True)])
def test_torch_pack_split_subset_identical(datasets, tmp_path, g_update, feature, use_ring):
    (je, jn), (te, tn) = datasets
    jrec, jnbr = jax_pipeline.load_dataset(je, jn, "homo", use_ref=True, use_ring=use_ring)
    trec, tnbr = pipeline.load_dataset(te, tn, "homo", use_ref=True, use_ring=use_ring)
    kw = dict(g_update=g_update, feature=feature, use_ring=use_ring, max_buckets=3)
    jb = jax_pipeline.pack_dataset(jrec, jnbr, **kw)
    tb = pipeline.pack_dataset(trec, tnbr, csr_cache_path=str(tmp_path / "c.npz"),
                               csr_source_path=tn, **kw)
    tb_cached = pipeline.pack_dataset(trec, tnbr, csr_cache_path=str(tmp_path / "c.npz"),
                                      csr_source_path=tn, **kw)
    assert len(jb) == len(tb) == len(tb_cached) > 1
    for j, t, c in zip(jb, tb, tb_cached):
        assert j.shape == t.shape == c.shape
        assert set(j.inputs) == set(t.inputs)
        for k in j.inputs:
            np.testing.assert_array_equal(t.inputs[k], j.inputs[k], err_msg=k)
            np.testing.assert_array_equal(c.inputs[k], j.inputs[k], err_msg=k)
        np.testing.assert_array_equal(t.targets, j.targets)
        np.testing.assert_array_equal(t.indices, j.indices)
    splits_j = jax_pipeline.split_data(36, test_percent=0.2, seed=3)
    splits_t = pipeline.split_data(36, test_percent=0.2, seed=3)
    for a, b in zip(splits_j, splits_t):
        np.testing.assert_array_equal(a, b)
    assert [len(x) for x in pipeline.split_data(36, train_size=20, test_size=6, seed=1)] == [20, 10, 6]
    for sj, st in zip(splits_j, splits_t):
        for j, t in zip(jax_pipeline.subset_buckets(jb, sj), pipeline.subset_buckets(tb, st)):
            np.testing.assert_array_equal(t.indices, j.indices)
            for k in j.inputs:
                np.testing.assert_array_equal(t.inputs[k], j.inputs[k])


def test_torch_choose_buckets_identical():
    rng = np.random.default_rng(0)
    sizes = list(zip(rng.integers(3, 30, 200).tolist(), rng.integers(1, 20, 200).tolist()))
    assert pipeline.choose_buckets(sizes, 8, 8, 2) == jax_pipeline.choose_buckets(sizes, 8, 8, 2)


# --- BatchIterator (scann_tpu/data/pipeline.py:401; tests/test_pipeline.py:128-190) ---

def _iterator_buckets(datasets, tmp_path):
    (je, jn), (te, tn) = datasets
    jb = jax_pipeline.pack_dataset(*jax_pipeline.load_dataset(je, jn, "homo"), max_buckets=2)
    tb = pipeline.pack_dataset(*pipeline.load_dataset(te, tn, "homo"),
                               csr_cache_path=str(tmp_path / "c.npz"), csr_source_path=tn,
                               max_buckets=2)
    return jb, tb


@pytest.mark.parametrize("shuffle,drop", [(False, False), (True, False), (False, True),
                                          (True, True)])
def test_torch_batch_iterator_plans_match_jax(datasets, tmp_path, shuffle, drop):
    """The same plans as the JAX iterator for the same seed, epoch after epoch
    (shuffled wrap-around training batches, padded eval batches with their
    sample_mask), the same length and the same materialized batches."""
    jb, tb = _iterator_buckets(datasets, tmp_path)
    jit_ = jax_pipeline.BatchIterator(jb, batch_size=8, shuffle=shuffle, seed=3,
                                      drop_remainder=drop)
    tit = pipeline.BatchIterator(tb, batch_size=8, shuffle=shuffle, seed=3, drop_remainder=drop)
    assert len(tit) == len(jit_) and tit.num_structures == jit_.num_structures == 36
    for _ in range(2):
        tplans, jplans = tit.plans(), jit_.plans()
        assert len(tplans) == len(jplans) == len(tit)
        for (tbi, tidx, tmask), (jbi, jidx, jmask) in zip(tplans, jplans):
            assert tbi == jbi and len(tidx) == 8
            np.testing.assert_array_equal(tidx, jidx)
            np.testing.assert_array_equal(tmask, jmask)
    for (tbi, tin, ty, tm), (jbi, jin, jy, jm) in zip(tit, jit_):
        assert tbi == jbi
        np.testing.assert_array_equal(ty, jy)
        np.testing.assert_array_equal(tm, jm)
        for k in jin:
            np.testing.assert_array_equal(tin[k], jin[k])


def test_torch_batch_iterator_covers_eval_once_and_fills_train(datasets, tmp_path):
    """Eval sees each structure exactly once under its mask; a train bucket
    smaller than the batch still gives one full batch, as the JAX one does."""
    jb, tb = _iterator_buckets(datasets, tmp_path)
    seen = []
    for bi, idx, mask in pipeline.BatchIterator(tb, batch_size=16).plans():
        seen.extend(tb[bi].indices[idx][mask > 0].tolist())
    assert sorted(seen) == list(range(36))
    tiny = [pipeline.PackedBucket({k: v[:5] for k, v in tb[0].inputs.items()},
                                  tb[0].targets[:5], tb[0].indices[:5])]
    jtiny = [jax_pipeline.PackedBucket({k: v[:5] for k, v in jb[0].inputs.items()},
                                       jb[0].targets[:5], jb[0].indices[:5])]
    (bi, idx, mask), = pipeline.BatchIterator(tiny, batch_size=16, shuffle=True).plans()
    (_, jidx, _), = jax_pipeline.BatchIterator(jtiny, batch_size=16, shuffle=True).plans()
    assert len(idx) == 16 and mask.sum() == 16 and set(idx.tolist()) == set(range(5))
    np.testing.assert_array_equal(idx, jidx)
