"""The port's GalleryIndex (witw_tpu_torch.evaluation.index) against
witw_tpu's on the CPU, mirroring tests/test_eval.py's index tests at small
sizes.

Inputs are planted-structure embeddings from numpy ``default_rng``: each
query is a noisy window of its own gallery map. Tolerances are ROADMAP's:
distances within rtol 1e-5 / atol 1e-6, orientations and indices equal;
``fast`` (the bf16 frequency product) keeps test_eval's contract: the
planted top-1 equal and distances within 8e-2 of the exact ones.
"""

import numpy as np
import pytest

from witw_tpu.evaluation.index import GalleryIndex as JaxIndex
from witw_tpu_torch.evaluation.index import GalleryIndex

TOL = dict(rtol=1e-5, atol=1e-6)


def _random_embeds(rng, n, h=2, w=8, sw=5, c=3):
    o = rng.standard_normal((n, h, w, c)).astype(np.float32)
    s = rng.standard_normal((n, h, sw, c)).astype(np.float32)
    for i in range(n):
        start = rng.integers(0, w)
        cols = [(start + k) % w for k in range(sw)]
        s[i] = o[i][:, cols, :] + 0.1 * s[i]
    return o, s


def _pair(o, meta=None):
    return JaxIndex(o, meta=meta), GalleryIndex(o, meta=meta, device="cpu")


def test_index_needs_the_card_unless_asked_for_the_cpu(rng):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        GalleryIndex(np.zeros((2, 1, 4, 1), np.float32))


@pytest.mark.parametrize("gallery_chunk", [16, 64])
def test_search_matches_jax(rng, gallery_chunk):
    """test_eval.py:230 (top-k and persistence) at its size."""
    o, s = _random_embeds(rng, 40)
    jidx, idx = _pair(o)
    ji, jd, jo = jidx.search(s, k=5, gallery_chunk=gallery_chunk)
    i, d, orient = idx.search(s, k=5, gallery_chunk=gallery_chunk)
    assert i.dtype == np.int64 and d.dtype == np.float32 and orient.dtype == np.int32
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, **TOL)
    np.testing.assert_array_equal(orient, jo)
    assert np.mean(i[:, 0] == np.arange(40)) > 0.8


def test_npz_files_load_across_packages(rng, tmp_path):
    o, s = _random_embeds(rng, 12)
    meta = {"x": np.arange(12.0), "y": np.arange(12.0) * -2, "precision": "f32",
            "path": np.asarray([f"tiles/{i}.png" for i in range(12)])}
    jidx, idx = _pair(o, meta)
    jidx.save(str(tmp_path / "from_jax"))  # no extension: both append .npz
    idx.save(str(tmp_path / "from_port.npz"))
    for loaded in (GalleryIndex.load(str(tmp_path / "from_jax"), device="cpu"),
                   JaxIndex.load(str(tmp_path / "from_port.npz"))):
        np.testing.assert_array_equal(loaded.embeds, o)
        assert sorted(loaded.meta) == sorted(meta)
        for k, v in meta.items():
            np.testing.assert_array_equal(loaded.meta[k], np.asarray(v))
        assert str(loaded.meta["precision"]) == "f32"
    i, d, _ = GalleryIndex.load(str(tmp_path / "from_jax.npz"), device="cpu").search(s, k=3)
    ji, jd, _ = jidx.search(s, k=3)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, **TOL)


def test_score_all_resident_and_streamed_match_jax(rng):
    """test_eval.py:288: resident (the tables search() uses) and streamed
    score_all, a remainder chunk included."""
    o, s = _random_embeds(rng, 50, h=2, w=16, sw=10, c=4)
    jidx, idx = _pair(o)
    jd, jo = jidx.score_all(s, gallery_chunk=16, resident=True)
    for resident in (True, False, None):
        d, orient = idx.score_all(s, gallery_chunk=16, resident=resident)
        assert d.shape == orient.shape == (50, 50) and orient.dtype == np.int32
        np.testing.assert_allclose(d, jd, **TOL)
        np.testing.assert_array_equal(orient, jo)
    fo = idx._fo
    idx.search(s, k=2)
    assert idx._fo is fo  # one resident table for both
    assert idx._resident_bytes() <= GalleryIndex.RESIDENT_BYTES_MAX


def test_score_all_and_search_agree_at_scale(rng):
    """test_eval.py:259 at 5000 items: score_all's top entries are the
    search's, and both match witw_tpu's."""
    n, h, w, c = 5000, 1, 8, 2
    gal = rng.standard_normal((n, h, w, c)).astype(np.float32)
    q = rng.standard_normal((2, h, 4, c)).astype(np.float32)
    jidx, idx = _pair(gal)
    d_all, o_all = idx.score_all(q, gallery_chunk=1024)
    jd_all, jo_all = jidx.score_all(q, gallery_chunk=1024)
    np.testing.assert_allclose(d_all, jd_all, **TOL)
    i, d, orient = idx.search(q, k=10, gallery_chunk=1024)
    ji, jd, jo = jidx.search(q, k=10, gallery_chunk=1024)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, **TOL)
    np.testing.assert_array_equal(orient, jo)
    np.testing.assert_allclose(d_all[i[0], 0], d[0], **TOL)
    np.testing.assert_array_equal(o_all[i[0], 0], orient[0])


def test_search_approx_matches_jax(rng):
    """test_eval.py:316: with the whole gallery as candidates it is the
    exact search; with 8 candidates it keeps the planted top-1."""
    o, s = _random_embeds(rng, 48)
    jidx, idx = _pair(o)
    ie, de, oe = idx.search(s, k=5, gallery_chunk=16)
    ia, da, oa = idx.search_approx(s, k=5, candidates=48, query_block=13)
    np.testing.assert_array_equal(ia, ie)
    np.testing.assert_allclose(da, de, **TOL)
    np.testing.assert_array_equal(oa, oe)
    ja, jda, joa = jidx.search_approx(s, k=5, candidates=8, query_block=16)
    ia2, da2, oa2 = idx.search_approx(s, k=5, candidates=8, query_block=16)
    np.testing.assert_array_equal(ia2, ja)
    np.testing.assert_allclose(da2, jda, **TOL)
    np.testing.assert_array_equal(oa2, joa)
    assert np.mean(ia2[:, 0] == ie[:, 0]) > 0.9


def _chord_distance_f64(o, s, idx):
    """The exact oracle: each query's chord distance to each gallery item
    of ``idx`` [Q, k] by direct circular correlation in float64."""
    o, s = o.astype(np.float64), s.astype(np.float64)
    cols = (np.arange(o.shape[2])[:, None] + np.arange(s.shape[2])[None]) % o.shape[2]
    d = np.zeros(idx.shape)
    for q, row in enumerate(idx):
        for j, g in enumerate(row):
            win = o[g][:, cols, :]  # [h, W, sw, c]
            corr = np.einsum("hwkc,hkc->w", win, s[q])
            i = int(np.argmax(corr))
            d[q, j] = 2.0 * (1.0 - corr[i] / (np.linalg.norm(win[:, i]) * np.linalg.norm(s[q])))
    return d


def test_search_approx_narrow_fov_matches_jax(rng):
    """test_eval.py:339 at a serving-like width (sw / W = 12 / 64): the
    shifted-window descriptors equal witw_tpu's, and the prefilter keeps the
    exact top-1 in a 3% pool. The two packages' distances are within atol
    4e-6 of each other: at the daemon's dims (hc 64, W 64) the planted
    pairs' d = 2 (1 - cos) ~ 0.01 cancels, and the two f32 rFFTs (numpy's
    and torch's) and contraction orders differ by up to 1.3e-6. Against an
    f64 oracle of the same distances the port is the nearer: 7.9e-7 off,
    witw_tpu 1.4e-6 (this seed), so the port is held within the ground
    rule's atol 1e-6 of the oracle, and no farther from it than witw_tpu."""
    n, h, w, sw, c = 256, 4, 64, 12, 16
    o, s = _random_embeds(rng, n, h, w, sw, c)
    jidx, idx = _pair(o)
    np.testing.assert_allclose(idx._pooled(sw).numpy(), np.asarray(jidx._pooled(sw)), **TOL)
    assert idx._pooled(w).shape[1] == 1
    assert idx._pooled(sw).shape[1] == int(np.ceil(w / (sw // 2)))
    ie, _, _ = idx.search(s, k=5, gallery_chunk=128)
    ia, da, oa = idx.search_approx(s, k=5, candidates=8, query_block=64)
    ja, jda, joa = jidx.search_approx(s, k=5, candidates=8, query_block=64)
    np.testing.assert_array_equal(ia, ja)
    np.testing.assert_allclose(da, jda, rtol=1e-5, atol=4e-6)
    np.testing.assert_array_equal(oa, joa)
    assert np.mean(ia[:, 0] == ie[:, 0]) > 0.97
    exact = _chord_distance_f64(o, s, ia)
    np.testing.assert_allclose(da, exact, rtol=0, atol=1e-6)
    assert np.abs(da - exact).max() <= np.abs(np.asarray(jda) - exact).max()


def test_fast_keeps_the_planted_ranks(rng):
    """test_eval.py:59's contract for fast=True, beside witw_tpu's fast."""
    o, s = _random_embeds(rng, 48, h=2, w=16, sw=10, c=4)
    jidx, idx = _pair(o)
    planted = np.arange(48)
    i_e, d_e, _ = idx.search(s, k=3, gallery_chunk=16)
    i_f, d_f, _ = idx.search(s, k=3, gallery_chunk=16, fast=True)
    ji_f, jd_f, _ = jidx.search(s, k=3, gallery_chunk=16, fast=True)
    np.testing.assert_array_equal(i_e[:, 0], planted)
    np.testing.assert_array_equal(i_f[:, 0], planted)
    np.testing.assert_array_equal(ji_f[:, 0], planted)
    np.testing.assert_allclose(d_f, d_e, atol=8e-2)
    np.testing.assert_allclose(d_f, jd_f, atol=8e-2)
    de, oe = idx.score_all(s, gallery_chunk=16)
    df, of = idx.score_all(s, gallery_chunk=16, fast=True)
    np.testing.assert_allclose(df, de, atol=8e-2)
    np.testing.assert_array_equal(of[planted, planted], oe[planted, planted])
    ia_f, da_f, _ = idx.search_approx(s, k=3, candidates=12, fast=True)
    np.testing.assert_array_equal(ia_f[:, 0], planted)
    assert not np.array_equal(d_f, d_e)  # the approximation is taken


def test_duplicated_items_keep_the_lowest_index(rng):
    """Equal distances rank by ascending index (jax.lax.top_k's rule), also
    across chunks: a gallery with each planted map repeated."""
    o, s = _random_embeds(rng, 10, h=2, w=8, sw=5, c=3)
    gal = np.concatenate([o, o[::-1], o])  # item i at i, 19 - i and 20 + i
    jidx, idx = _pair(gal)
    for chunk in (4, 7, 64):
        i, d, _ = idx.search(s, k=6, gallery_chunk=chunk)
        ji, jd, _ = jidx.search(s, k=6, gallery_chunk=chunk)
        np.testing.assert_array_equal(i[:, :3], np.stack([np.arange(10), 19 - np.arange(10),
                                                          20 + np.arange(10)], 1))
        assert np.all(d[:, 0] == d[:, 1]) and np.all(d[:, 1] == d[:, 2])
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(d, jd, **TOL)
