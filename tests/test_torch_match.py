"""Match math of the PyTorch port against witw_tpu on the CPU.

Correlation (matmul and fft forms), window norms, chord distance and the FFT
matcher: rtol 1e-5, atol 1e-6, orientations equal (f32 roundoff of sums
taken in another order). The fused module's plain version is held against
the Pallas kernel in interpret mode, as tests/test_pallas_match.py runs it.
Evaluator ranks are compared on planted-structure data, where distances are
well separated, and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from witw_tpu.evaluation import gallery as jgallery
from witw_tpu.match import correlation as jcorr
from witw_tpu.match import distance as jdist
from witw_tpu.match import fft_matcher as jfft
from witw_tpu.ops.pallas.fused_match import fused_chord_distance_nhwc as pallas_nhwc
from witw_tpu_torch.evaluation import gallery as tgallery
from witw_tpu_torch.match import correlation as tcorr
from witw_tpu_torch.match import distance as tdist
from witw_tpu_torch.match import fft_matcher as tfft
from witw_tpu_torch.ops import fused_match

TOL = dict(rtol=1e-5, atol=1e-6)


def _maps(rng, g=6, q=4, h=2, w=8, c=3, sw=5):
    o = rng.standard_normal((g, h, w, c)).astype(np.float32)
    s = rng.standard_normal((q, h, sw, c)).astype(np.float32)
    return o, s


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _planted(rng, n, h, w, c, sw):
    """Each surface is a noisy window of its own overhead map, as
    tests/test_pallas_match.py plants it: well-separated distances."""
    o = rng.standard_normal((n, h, w, c)).astype(np.float32)
    s = rng.standard_normal((n, h, sw, c)).astype(np.float32)
    for i in range(n):
        start = rng.integers(0, w)
        cols = [(start + k) % w for k in range(sw)]
        s[i] = o[i][:, cols, :] + 0.1 * s[i]
    return o, s


@pytest.mark.parametrize("method", ["matmul", "fft"])
@pytest.mark.parametrize("sw", [8, 5, 1])
def test_circular_correlation_matches_jax(rng, method, sw):
    o, s = _maps(rng, sw=sw)
    want = np.asarray(jcorr.circular_correlation(jnp.asarray(o), jnp.asarray(s), method))
    got = tcorr.circular_correlation(*_t(o, s), method=method).numpy()
    assert got.shape == (6, 4, 8)
    np.testing.assert_allclose(got, want, **TOL)


def test_circular_correlation_rejects_wide_query(rng):
    o, _ = _maps(rng)
    s = rng.standard_normal((2, 2, 9, 3)).astype(np.float32)
    with pytest.raises(ValueError):
        tcorr.circular_correlation(*_t(o, s))


@pytest.mark.parametrize("window", [1, 5, 8])
def test_window_sq_norms_matches_jax(rng, window):
    o, _ = _maps(rng)
    want = np.asarray(jdist.window_sq_norms(jnp.asarray(o), window))
    got = tdist.window_sq_norms(torch.from_numpy(o), window).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("sw", [8, 5])
def test_chord_distance_matches_jax(rng, sw):
    o, s = _maps(rng, sw=sw)
    corr = np.asarray(jcorr.circular_correlation(jnp.asarray(o), jnp.asarray(s)))
    want_d, want_or = jdist.chord_distance(jnp.asarray(o), jnp.asarray(s), jnp.asarray(corr))
    got_d, got_or = tdist.chord_distance(*_t(o, s, corr))
    np.testing.assert_array_equal(got_or.numpy(), np.asarray(want_or))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)


def test_chord_distance_degenerate_maps_are_finite(rng):
    o, s = _maps(rng)
    o[0] = 0.0
    s[1] = 0.0
    got_d, _ = tdist.chord_distance(*_t(o, s), tcorr.circular_correlation(*_t(o, s)))
    assert torch.isfinite(got_d).all()
    np.testing.assert_allclose(got_d[0].numpy(), 2.0)


@pytest.mark.parametrize("w", [7, 8, 64])
def test_irdft_mats_copy_equals_jax(w):
    want_c, want_s = jfft._irdft_mats(w)
    got_c, got_s = tfft._irdft_mats(w)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_s, want_s)


@pytest.mark.parametrize("sw", [8, 5])
def test_fft_matcher_matches_jax(rng, sw):
    o, s = _maps(rng, sw=sw)
    w = o.shape[2]
    fs_j, sn_j = jfft.query_fft(jnp.asarray(s), w)
    fs_t, sn_t = tfft.query_fft(torch.from_numpy(s), w)
    np.testing.assert_allclose(fs_t.numpy(), np.asarray(fs_j), **TOL)
    np.testing.assert_allclose(sn_t.numpy(), np.asarray(sn_j), **TOL)

    fo = np.asarray(jnp.fft.rfft(jnp.asarray(o), axis=2))
    wsq = np.asarray(jdist.window_sq_norms(jnp.asarray(o), sw))
    fs, sn = np.asarray(fs_j), np.asarray(sn_j)
    want_d, want_or = jfft.gallery_vs_queries(fo, wsq, fs, sn, w)
    got_d, got_or = tfft.gallery_vs_queries(*_t(fo, wsq, fs, sn), w)
    np.testing.assert_array_equal(got_or.numpy(), np.asarray(want_or))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)

    # per-query candidates: query q against gallery rows (q, q+1) mod G
    cand = np.stack([np.arange(4), (np.arange(4) + 1) % 6], axis=1)
    want_d, want_or = jfft.candidates_vs_queries(fo[cand], wsq[cand], fs, sn, w)
    got_d, got_or = tfft.candidates_vs_queries(*_t(fo[cand], wsq[cand], fs, sn), w)
    np.testing.assert_array_equal(got_or.numpy(), np.asarray(want_or))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)


def test_chord_scores_and_irfft_small_match_jax(rng):
    corr = rng.standard_normal((5, 3, 8)).astype(np.float32)
    wsq = rng.uniform(0.5, 2.0, (5, 1, 8)).astype(np.float32)
    sn = rng.uniform(0.5, 2.0, (1, 3)).astype(np.float32)
    want_d, want_or = jfft.chord_scores(jnp.asarray(corr), jnp.asarray(wsq), jnp.asarray(sn))
    got_d, got_or = tfft.chord_scores(*_t(corr, wsq, sn))
    np.testing.assert_array_equal(got_or.numpy(), np.asarray(want_or))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)

    spec = np.fft.rfft(rng.standard_normal((4, 8)), axis=-1)
    re, im = spec.real.astype(np.float32), spec.imag.astype(np.float32)
    want = np.asarray(jfft._irfft_small((jnp.asarray(re), jnp.asarray(im)), 8))
    got = tfft._irfft_small(_t(re, im), 8).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("g,q,h,w,c,sw", [
    (8, 4, 2, 8, 3, 8),
    (8, 4, 2, 8, 3, 5),
    (6, 3, 1, 8, 4, 5),  # G not a multiple of the Pallas g_blk of 4
])
def test_fused_plain_matches_pallas_interpret(rng, g, q, h, w, c, sw):
    o, s = _maps(rng, g, q, h, w, c, sw)
    want_d, want_or = pallas_nhwc(jnp.asarray(o), jnp.asarray(s), g_blk=4, interpret=True)
    got_d, got_or = fused_match.fused_chord_distance_plain(*_t(o, s))
    np.testing.assert_array_equal(got_or.numpy(), np.asarray(want_or))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)


def test_fused_wrapper_on_cpu_takes_plain_version(rng, monkeypatch):
    monkeypatch.setattr(fused_match, "launches", 0)
    o, s = _t(*_maps(rng))
    d, orient = fused_match.fused_chord_distance_nhwc(o, s)
    want_d, want_or = fused_match.fused_chord_distance_plain(o, s)
    assert fused_match.launches == 0
    assert d.shape == (6, 4) and orient.dtype == torch.int32
    assert torch.equal(d, want_d) and torch.equal(orient, want_or)


def _flat_inputs(g=4, w=8, hc=6, sw=5, q=3):
    return (torch.zeros(g, w, hc), torch.zeros(sw, q, hc), torch.zeros(g, w))


@pytest.mark.parametrize("case", [
    "cpu", "dtype", "noncontiguous", "wide_query", "shape", "smem",
])
def test_fused_kernel_rejects_what_it_does_not_take(case):
    o, s, wsq = _flat_inputs()
    if case == "dtype":
        o = o.double()
    elif case == "noncontiguous":
        s = torch.zeros(3, 5, 6).permute(1, 0, 2)
    elif case == "wide_query":
        s = torch.zeros(9, 3, 6)
    elif case == "shape":
        wsq = torch.zeros(4, 7)
    elif case == "smem":
        # Past W = 1720 the whole maps do not fit shared memory; the kernel
        # now takes such shapes on windows of the maps, so the CPU inputs
        # are refused only by the device check.
        o, s, wsq = _flat_inputs(w=1721, hc=64)
        assert fused_match.geometry(4, 3, 1721, 64)["kcols"] < 1721
        assert fused_match.smem_bytes(1721, 64, 5) <= fused_match.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError):
        fused_match.fused_corr_distance(o, s, wsq)
    assert fused_match.launches == 0


@pytest.mark.parametrize("use_fused", [False, True])
def test_evaluator_ranks_match_jax(rng, use_fused):
    n, h, w, c, sw = 24, 2, 8, 3, 5
    o, s = _planted(rng, n, h, w, c, sw)
    want = jgallery.FovGalleryEvaluator(
        query_block=8, gallery_chunk=8, use_pallas=use_fused).ranks(o, s)
    got = tgallery.FovGalleryEvaluator(
        query_block=8, gallery_chunk=10, use_fused=use_fused, device="cpu").ranks(o, s)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 1 and got.max() <= n


def test_evaluator_asymmetric_gallery_matches_jax(rng):
    o, s = _planted(rng, 20, 1, 8, 4, 8)
    tm = rng.permutation(20)[:12]
    s = s[tm]
    want = jgallery.FovGalleryEvaluator(query_block=8, gallery_chunk=8).ranks(o, s, tm)
    for use_fused in (False, True):
        got = tgallery.FovGalleryEvaluator(
            query_block=5, gallery_chunk=7, use_fused=use_fused, device="cpu").ranks(o, s, tm)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tgallery.FovGalleryEvaluator(device="cpu").ranks(o, s)


def test_metrics_from_ranks_matches_jax(rng):
    ranks = rng.integers(1, 200, 150).astype(np.int32)
    assert tgallery.metrics_from_ranks(ranks) == jgallery.metrics_from_ranks(ranks)
