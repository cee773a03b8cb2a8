"""The fused match kernel's arithmetic and layout on the CPU.

``csrc/fused_match.cu`` computes the correlation on the tensor cores as
3xTF32: every f32 value x is split into big = rna_tf32(x) and small =
rna_tf32(x - big), and each width column adds small*big + big*small +
big*big, the small terms first, into an f32 sum. The kernel runs only on the
card; here a torch emulation of that arithmetic (defined in this file, not
in the package) is held against the Pallas kernel in interpret mode at the
card tests' tolerances (rtol 1e-5, atol 1e-6, orientations equal outside
near ties whose top-2 gap is at most 1e-5 of the max), which shows that
3xTF32 meets them before the card is used; past 64 channels, or where the
maps would not fit shared memory, the emulation runs the kernel's channel
chunks, and past sw = 1720 its several windows of the maps a pass, in the
kernel's order of items. ``geometry`` (rows, channel chunks and padding, query pitch, ring
stages, shared memory, grid) is checked against Hopper's 232,448 bytes of
shared memory a block, and ``query_columns`` (the query layout the kernel's
bulk copies read) against the queries it lays out.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from witw_tpu.ops.pallas.fused_match import fused_chord_distance_nhwc as pallas_nhwc
from witw_tpu_torch.match.correlation import circular_correlation
from witw_tpu_torch.match.distance import window_sq_norms
from witw_tpu_torch.ops import fused_match

TOL = dict(rtol=1e-5, atol=1e-6)
TIE_REL = 1e-5


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, to nearest, ties away from
    zero (add half of the dropped 13 bits' range to the magnitude, then
    clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def emulated_kernel(o: np.ndarray, s: np.ndarray):
    """The kernel's arithmetic on [G, h, W, c] x [Q, h, sw, c]: per window
    of ``kcols`` query columns, channel chunk and width column k, in that
    order (``geometry``), acc = s_small o_big +
    s_big o_small + s_big o_big (f32 sums of exact tf32 products), added
    into the total; then max, first argmax and the chord distance with the
    kernel's expression."""
    o_t, s_t = torch.tensor(o), torch.tensor(s)
    g, h, w, c = o_t.shape
    q, _, sw, _ = s_t.shape
    o_flat = o_t.permute(0, 2, 1, 3).reshape(g, w, h * c)
    s_swqh = s_t.permute(2, 0, 1, 3).reshape(sw, q, h * c)
    o_big, o_small = split_tf32(o_flat)
    s_big, s_small = split_tf32(s_swqh)
    geo = fused_match.geometry(g, q, w, h * c, sw)
    kcols = geo["kcols"]
    tot = torch.zeros(g, q, w)
    for k0 in range(0, sw, kcols):
        for ch in range(geo["chunks"]):
            j = slice(ch * geo["hc_pad"], (ch + 1) * geo["hc_pad"])
            for k in range(k0, min(k0 + kcols, sw)):
                ob, osm = torch.roll(o_big, -k, 1), torch.roll(o_small, -k, 1)
                acc = torch.einsum("qj,gwj->gqw", s_small[k][:, j], ob[..., j])
                acc = acc + torch.einsum("qj,gwj->gqw", s_big[k][:, j], osm[..., j])
                acc = acc + torch.einsum("qj,gwj->gqw", s_big[k][:, j], ob[..., j])
                tot = tot + acc
    best, orient = tot.max(dim=-1)
    wsq = torch.gather(window_sq_norms(o_t, sw), 1, orient)
    s_norm = torch.sqrt((s_swqh * s_swqh).sum(dim=(0, 2)))
    cos = best * (1.0 / torch.sqrt(wsq.clamp_min(1e-20))) / s_norm.clamp_min(1e-10)[None, :]
    return 2.0 * (1.0 - cos), orient.to(torch.int32)


def _maps(rng, g, q, h, w, c, sw, scale=1.0):
    o = (scale * rng.standard_normal((g, h, w, c))).astype(np.float32)
    s = (scale * rng.standard_normal((q, h, sw, c))).astype(np.float32)
    return o, s


def _assert_matches_pallas(o, s):
    want_d, want_or = pallas_nhwc(jnp.asarray(o), jnp.asarray(s), g_blk=4, interpret=True)
    want_d, want_or = torch.tensor(np.asarray(want_d)), torch.tensor(np.asarray(want_or))
    got_d, got_or = emulated_kernel(o, s)
    if o.shape[2] > 1:
        top2 = torch.topk(circular_correlation(torch.tensor(o), torch.tensor(s)), 2, dim=-1).values
        keep = (top2[..., 0] - top2[..., 1]) > TIE_REL * top2[..., 0].abs()
    else:
        keep = torch.ones_like(got_d, dtype=torch.bool)
    assert torch.equal(got_or[keep], want_or[keep])
    torch.testing.assert_close(got_d[keep], want_d[keep], **TOL)
    return got_or, want_or


@pytest.mark.parametrize("g,q,h,w,c,sw,scale", [
    (8, 4, 2, 8, 3, 8, 1.0),
    (6, 3, 1, 8, 4, 5, 1.0),
    (3, 2, 1, 1, 2, 1, 1.0),
    (5, 9, 2, 100, 8, 33, 1.0),  # widths above one 64-shift pass
    (3, 4, 2, 100, 8, 100, 1.0),  # sw = W: every window wraps
    (7, 5, 1, 12, 6, 1, 1.0),  # hc 6, sw 1, G odd
    (4, 3, 4, 16, 5, 9, 1.0),  # hc 20
    (3, 5, 2, 16, 8, 12, 1e3),  # values scaled by 1e3
    (4, 6, 4, 64, 16, 64, 1.0),  # CVUSA widths: W = sw = hc = 64
    (3, 4, 4, 64, 16, 16, 1.0),  # CVUSA widths at fov 90
    (3, 4, 4, 64, 32, 64, 1.0),  # hc 128: two chunks of 64 channels
    (3, 4, 4, 128, 16, 64, 1.0),  # W 128 at hc 64: two chunks of 32
    (4, 3, 4, 20, 18, 9, 1.0),  # hc 72: two chunks of 40, the last part zeros
    (2, 3, 4, 1721, 16, 140, 1.0),  # past W = 1720: windows of 127 columns at hc 64
])
def test_3xtf32_emulation_meets_the_card_tolerances(rng, g, q, h, w, c, sw, scale):
    _assert_matches_pallas(*_maps(rng, g, q, h, w, c, sw, scale))


def test_3xtf32_emulation_keeps_the_lowest_index_of_an_exact_tie(rng):
    # A gallery map of period W / 2 correlates equally at shifts i and i + W / 2.
    o, s = _maps(rng, 4, 5, 2, 16, 8, 10)
    o[:, :, 8:] = o[:, :, :8]
    got_or, want_or = _assert_matches_pallas(o, s)
    assert torch.equal(got_or, want_or)
    assert int(got_or.max()) < 8


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),  # a tie rounds away from zero
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 3 * 2.0**-11, 1.0 + 2.0**-9),  # a tie above an odd mantissa, away too
    (1.0 + 2.0**-11 - 2.0**-23, 1.0),  # just under the tie rounds down
    (1.0 + 2.0**-11 + 2.0**-23, 1.0 + 2.0**-10),
    (3.0 * 2.0**-20, 3.0 * 2.0**-20),  # already tf32
    (0.0, 0.0),
    (-0.0, -0.0),
    (2.0**-126 * (1 + 2.0**-11), 2.0**-126 * (1 + 2.0**-10)),  # smallest normal exponent
])
def test_tf32_rounding_of_known_values(x, want):
    got = tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want
    assert np.signbit(got.item()) == np.signbit(want)


def test_3xtf32_split_is_exact_to_2_to_the_minus_22(rng):
    x = torch.tensor(rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096)), dtype=torch.float32)
    big, small = split_tf32(x)
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    rest = (x.double() - big.double() - small.double()).abs()
    assert bool((rest <= 2.0**-22 * x.double().abs()).all())


def test_geometry_of_the_main_path():
    # CVUSA: o [G, 64, 64], s [64, Q, 64], batch 128 and the gallery block.
    geo = fused_match.geometry(128, 128, 64, 64)
    assert geo == {"rows": 127, "chunks": 1, "hc_pad": 64, "pitch": 72, "maps": 2, "stages": 4,
                   "smem_bytes": 2 * 2 * 64 * 4 * 127 + 4 * (64 * 72 * 4 + 16),
                   "grid": (64, 2), "kcols": 64}
    assert geo["smem_bytes"] == 203840 <= fused_match.SMEM_LIMIT_BYTES
    assert fused_match.geometry(8832, 128, 64, 64)["grid"] == (4416, 2)
    assert fused_match.geometry(1024, 256, 64, 64)["grid"] == (512, 4)  # test_ranks' chunks


@pytest.mark.parametrize("g,q,w,hc", [
    (8, 4, 8, 6), (6, 3, 8, 4), (37, 70, 64, 64), (5, 9, 100, 16), (3, 2, 1, 2),
    (7, 5, 12, 6), (4, 3, 16, 20), (3, 4, 100, 16), (1, 1, 127, 64),
    (5, 6, 64, 128), (5, 6, 128, 64), (4, 5, 20, 72), (3, 4, 256, 64), (2, 3, 1720, 512),
])
def test_geometry_fits_every_card_test_shape(g, q, w, hc):
    geo = fused_match.geometry(g, q, w, hc)
    assert geo["stages"] >= fused_match.MIN_STAGES
    assert geo["smem_bytes"] <= fused_match.SMEM_LIMIT_BYTES
    assert geo["hc_pad"] % 8 == 0 and geo["hc_pad"] <= 8 * fused_match.MAX_STEPS
    # The chunks cover hc, and none is all padding.
    assert geo["hc_pad"] * (geo["chunks"] - 1) < hc <= geo["hc_pad"] * geo["chunks"]
    assert geo["rows"] == w + fused_match.SHIFTS - 1
    assert geo["grid"] == (-(-g // 2), -(-q // 64))


@pytest.mark.parametrize("w,hc,chunks,hc_pad", [
    (64, 64, 1, 64),  # CVUSA: one chunk
    (127, 64, 1, 64),  # the widest map that fits whole at hc 64
    (128, 64, 2, 32),  # overhead tiles of 512: W 128
    (256, 64, 2, 32),
    (64, 128, 2, 64),  # a head of 32 channels: hc 128
    (8, 72, 2, 40),  # 9 steps: two chunks of 5
    (512, 512, 32, 16),
    (1720, 512, 64, 8),  # the widest map whose columns fit one window
])
def test_geometry_takes_the_fewest_channel_chunks_that_fit(w, hc, chunks, hc_pad):
    geo = fused_match.geometry(4, 4, w, hc)
    assert (geo["chunks"], geo["hc_pad"], geo["stages"] >= 2) == (chunks, hc_pad, True)
    # One chunk fewer leaves no room for two ring stages, or has more than
    # 8 steps a chunk.
    steps = -(-hc // 8)
    if chunks > 1:
        fewer = 8 * -(-steps // (chunks - 1))
        pitch = fewer + (0 if fewer % 32 in (8, 24) else 8)
        need = 2 * 2 * fewer * 4 * (w + 63) + 2 * (64 * pitch * 4 + 16)
        assert fewer > 64 or need > fused_match.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("w,hc", [(1721, 1), (1721, 64), (2000, 512)])
def test_geometry_rejects_what_does_not_fit(w, hc):
    # Maps whose sw = W columns do not fit one window, once refused, are held
    # as several windows a pass now; the wrapper goes on to its device
    # checks, which refuse these CPU tensors.
    assert fused_match.geometry(4, 4, w, hc)["kcols"] < w
    for sw in (1, 64, w):
        geo = fused_match.geometry(4, 4, w, hc, sw)
        assert 1 <= geo["kcols"] <= sw and geo["rows"] == geo["kcols"] + 63
        assert geo["stages"] >= fused_match.MIN_STAGES
        assert geo["smem_bytes"] <= fused_match.SMEM_LIMIT_BYTES
    o, s, wsq = torch.zeros(4, w, hc), torch.zeros(1, 3, hc), torch.zeros(4, w)
    with pytest.raises(ValueError, match="CUDA"):
        fused_match.fused_corr_distance(o, s, wsq)


@pytest.mark.parametrize("w", [1, 8, 63, 64, 65, 100, 127, 128, 255, 256, 512, 829, 1024, 1720,
                               1721, 2048, 4096, 9000])
def test_geometry_takes_one_window_wherever_it_fits(w):
    """Every sw gets a valid layout. A window holds all sw columns in the
    fewest chunks that leave two ring stages, so every shape the kernel
    held whole before (sw <= W <= 1720) runs the same items in the same
    order as then; only past sw = 1720 are there several windows a pass,
    in 8-step chunks, each of the most columns that fit."""
    for hc in (1, 6, 8, 16, 20, 64, 72, 128, 512):
        steps = -(-hc // 8)
        for sw in sorted({1, min(w, 64), w}):
            geo = fused_match.geometry(3, 5, w, hc, sw)
            assert geo["stages"] >= fused_match.MIN_STAGES
            assert geo["smem_bytes"] <= fused_match.SMEM_LIMIT_BYTES
            assert geo["hc_pad"] * (geo["chunks"] - 1) < hc <= geo["hc_pad"] * geo["chunks"]
            assert 1 <= geo["kcols"] <= sw and geo["rows"] == geo["kcols"] + 63
            row_bytes = 2 * 2 * geo["hc_pad"] * 4
            stage = 64 * geo["pitch"] * 4 + 16
            assert (geo["kcols"] == sw) == (sw <= 1720)
            if geo["kcols"] == sw:
                # One chunk fewer leaves no room for two ring stages, or has
                # more than 8 steps a chunk.
                if geo["chunks"] > 1:
                    fewer = 8 * -(-steps // (geo["chunks"] - 1))
                    pitch = fewer + (0 if fewer % 32 in (8, 24) else 8)
                    need = 2 * 2 * fewer * 4 * (sw + 63) + 2 * (64 * pitch * 4 + 16)
                    assert fewer > 64 or need > fused_match.SMEM_LIMIT_BYTES
                continue
            assert geo["chunks"] == -(-steps // 8)
            assert geo["hc_pad"] == 8 * -(-steps // geo["chunks"])
            assert row_bytes * (geo["rows"] + 1) + 2 * stage > fused_match.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("sw,q,w,hc", [(3, 5, 8, 6), (2, 70, 64, 64), (3, 4, 64, 128), (2, 3, 20, 72),
                                       (2, 3, 8, 8)])
def test_query_columns_lays_out_each_chunk_of_each_row(rng, sw, q, w, hc):
    s = torch.tensor(rng.standard_normal((sw, q, hc)), dtype=torch.float32)
    geo = fused_match.geometry(4, q, w, hc)
    got = fused_match.query_columns(s, geo)
    n, pitch = geo["hc_pad"], geo["pitch"]
    assert got.shape == (sw, geo["chunks"], q, pitch) and got.is_contiguous()
    assert got.data_ptr() % 16 == 0
    for ch in range(geo["chunks"]):
        part = s[..., ch * n:(ch + 1) * n]
        assert torch.equal(got[:, ch, :, :part.shape[-1]], part)
        assert not bool(got[:, ch, :, part.shape[-1]:].any())


def test_query_columns_copies_a_view_the_bulk_copies_cannot_read():
    # hc 8 = pitch: an aligned, contiguous s is taken as it is; one 4 bytes
    # off 16-byte alignment (a sliced buffer) is copied.
    buf = torch.arange(1 + 2 * 3 * 8, dtype=torch.float32)
    geo = fused_match.geometry(4, 3, 8, 8)
    aligned = buf[:48].view(2, 3, 8)
    assert geo["pitch"] == 8 and aligned.data_ptr() % 16 == 0
    assert fused_match.query_columns(aligned, geo).data_ptr() == aligned.data_ptr()
    shifted = buf[1:].view(2, 3, 8)
    got = fused_match.query_columns(shifted, geo)
    assert got.data_ptr() % 16 == 0 and torch.equal(got[:, 0], shifted)


def test_query_pitch_spreads_fragment_loads_over_all_banks():
    # A half warp's 8-byte loads: rows g < 4, channels 2t and 2t + 1 (t < 4).
    for hc in range(1, 129):
        geo = fused_match.geometry(1, 1, 8, hc)
        pitch = geo["pitch"]
        assert pitch % 4 == 0 and pitch >= geo["hc_pad"]
        banks = {(g * pitch + 2 * t + e) % 32 for g in range(4) for t in range(4) for e in range(2)}
        assert len(banks) == 32, hc
