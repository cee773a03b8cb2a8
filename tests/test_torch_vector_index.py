"""The port's VectorIndex (witw_tpu_torch.evaluation.vector_index) against
witw_tpu's on the CPU: the npz contract both ways, ``search`` (indices equal,
ties included: the lower index first, as jax.lax.top_k keeps it; distances
within rtol 1e-5, atol 1e-6) and ``score_all``, resident and streamed.
Galleries come from a numpy seed.
"""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import numpy as np
import pytest
import torch

from witw_tpu.evaluation.index import GalleryIndex as JaxGalleryIndex
from witw_tpu.evaluation.vector_index import VectorIndex as JaxVectorIndex
from witw_tpu_torch.evaluation.vector_index import VectorIndex


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture
def gallery(rng):
    """60 unit vectors with exact duplicates (rows 7 and 41 copy 3, row 50
    copies 12) and 5 queries, two of them on duplicated rows."""
    g = _unit(rng.standard_normal((60, 32)))
    g[[7, 41]] = g[3]
    g[50] = g[12]
    q = _unit(rng.standard_normal((5, 32)))
    q[1] = g[3]
    q[3] = _unit(g[12] + 0.01 * rng.standard_normal(32))
    return g, q


def test_search_matches_jax_ties_included(gallery):
    g, q = gallery
    meta = {"x": np.arange(60.0)}
    want_i, want_d = JaxVectorIndex(g, meta).search(q, k=6)
    index = VectorIndex(g, meta, device="cpu")
    got_i, got_d = index.search(q, k=6)
    assert got_i.dtype == np.int64 and got_d.dtype == np.float32
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-6)
    assert got_i[1, :3].tolist() == [3, 7, 41]  # the tie in ascending index order
    assert got_i[3, :2].tolist() == [12, 50]
    i_all, _ = index.search(q, k=100)  # k clamps to the gallery
    assert i_all.shape == (5, 60)


@pytest.mark.parametrize("resident", [True, False])
def test_score_all_matches_jax(gallery, resident):
    g, q = gallery
    want = JaxVectorIndex(g).score_all(q, gallery_chunk=16, resident=resident)
    got = VectorIndex(g, device="cpu").score_all(q, gallery_chunk=16, resident=resident)
    assert got.shape == (60, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_save_load_round_trip_with_jax(gallery, tmp_path):
    """Either package loads the other's file (meta included); a 4-D
    (GalleryIndex) file is refused by both with the same error."""
    g, _ = gallery
    meta = {"x": np.arange(60.0), "precision": "int8", "family": "safa"}
    VectorIndex(g, meta, device="cpu").save(str(tmp_path / "port"))
    JaxVectorIndex(g, meta).save(str(tmp_path / "jax.npz"))
    for src, cls in (("port.npz", JaxVectorIndex), ("jax", VectorIndex)):
        kw = {} if cls is JaxVectorIndex else {"device": "cpu"}
        loaded = cls.load(str(tmp_path / src), **kw)
        np.testing.assert_array_equal(loaded.embeds, g)
        assert sorted(loaded.meta) == ["family", "precision", "x"]
        assert str(loaded.meta["family"]) == "safa"
        np.testing.assert_array_equal(loaded.meta["x"], meta["x"])
    JaxGalleryIndex(np.zeros((2, 1, 4, 2), np.float32)).save(str(tmp_path / "maps"))
    with pytest.raises(ValueError, match="GalleryIndex.load"):
        JaxVectorIndex.load(str(tmp_path / "maps"))
    with pytest.raises(ValueError, match="GalleryIndex.load"):
        VectorIndex.load(str(tmp_path / "maps"), device="cpu")
    with pytest.raises(ValueError, match="GalleryIndex"):
        VectorIndex(np.zeros((2, 1, 4, 2), np.float32), device="cpu")


def test_index_defaults_to_the_card(gallery):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorIndex(gallery[0])
