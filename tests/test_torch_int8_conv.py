"""Kernel A of the port's static-int8 towers (witw_tpu_torch.ops.int8_conv)
on the CPU: its plain version against the Pallas TPU kernels it replaces,
and the weight table its CUDA kernel reads.

- Rows 7, 8 and 10 of the TPU kernel table, ``exp/int8_conv_pallas.py:
  conv3x3_int8``, ``exp/int8_conv_v2.py:conv3x3_int8_v2`` and
  ``exp/r4_conv_taps.py:conv3x3_int8_taps``, run under
  ``force_tpu_interpret_mode()`` on the same numpy inputs as
  ``conv3x3_int8_plain``: bit-equal, ReLU folded, ``bias_q`` 0. Rows 7 and 8
  take NHWC with H a multiple of their 8-row slab; row 10 keeps Co = Cin in
  the TPU-lane layout [B, H, C, W] with the width circular, which the port
  computes as ``wrap_pad_width`` by 1 and then ``pad_w`` 0.
- ``pack_weights_wgmma`` / ``unpack_weights_wgmma``: the round trip, the
  zero padding, and the byte order of the kernel's ``wgmma`` B descriptor.

The three root ``exp`` scripts put an absolute checkout path first on
``sys.path`` and point JAX's compilation cache there when imported; the
``jax_exp`` fixture imports them and undoes both before anything compiles.
"""

import importlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from witw_tpu_torch.models.backbones.vgg16 import wrap_pad_width
from witw_tpu_torch.ops import int8_conv

ROWS = ("int8_conv_pallas", "int8_conv_v2", "r4_conv_taps")


@pytest.fixture(scope="module")
def jax_exp():
    """The root ``exp`` scripts of rows 7, 8 and 10, with ``sys.path`` and the
    compilation cache directory restored to what they were before the
    import."""
    path, cache_dir = list(sys.path), jax.config.jax_compilation_cache_dir
    try:
        mods = {name: importlib.import_module(f"exp.{name}") for name in ROWS}
    finally:
        sys.path[:] = path
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return types.SimpleNamespace(**mods)


def _case(seed, b, h, w, c, n):
    """int8 x [B, H, W, C], HWIO weights in [-20, 20] and per-channel requant
    scales that spread the ReLU'd outputs over [0, 127]."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, h, w, c), dtype=np.int64).astype(np.int8)
    k = rng.integers(-20, 21, (3, 3, c, n), dtype=np.int64).astype(np.int8)
    acc_std = np.sqrt(9 * c) * 73.3 * 11.8
    m = (rng.uniform(20.0, 60.0, n) / acc_std).astype(np.float32)
    return x, k, m


def _plain(x, k, m, pad_w):
    co = k.shape[-1]
    return int8_conv.conv3x3_int8_plain(
        torch.from_numpy(x), torch.from_numpy(int8_conv.pack_weights(k)),
        torch.zeros(co, dtype=torch.int32), torch.from_numpy(m), 1, pad_w, relu=True).numpy()


@pytest.mark.parametrize("shape", [(2, 16, 20, 32, 32), (1, 8, 37, 16, 64), (2, 24, 9, 64, 16)])
@pytest.mark.parametrize("row", ROWS)
def test_plain_equals_pallas_rows_7_8_10(jax_exp, row, shape):
    b, h, w, c, n = shape
    if row == "r4_conv_taps":
        n = c  # the taps kernel writes Co = Cin
    x, k, m = _case(sum(shape), b, h, w, c, n)
    with pltpu.force_tpu_interpret_mode():
        if row == "int8_conv_pallas":
            want = jax_exp.int8_conv_pallas.conv3x3_int8(
                jnp.asarray(x), jnp.asarray(k.reshape(9 * c, n)), jnp.asarray(m[None]))
        elif row == "int8_conv_v2":
            want = jax_exp.int8_conv_v2.conv3x3_int8_v2(
                jnp.asarray(x), jnp.asarray(k.reshape(9 * c, n)), jnp.asarray(m[None]))
        else:
            want = jnp.transpose(jax_exp.r4_conv_taps.conv3x3_int8_taps(
                jnp.asarray(np.transpose(x, (0, 1, 3, 2))),
                jnp.asarray(jax_exp.r4_conv_taps.pack_taps(k)), jnp.asarray(m[:, None])),
                (0, 1, 3, 2))
        want = np.asarray(want)
    if row == "r4_conv_taps":
        xw = wrap_pad_width(torch.from_numpy(x), 1, dim=2).numpy()
        got = _plain(xw, k, m, pad_w=0)
    else:
        got = _plain(x, k, m, pad_w=1)
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape == (b, h, w, n)
    assert 0.2 < (got > 0).mean() < 0.8 and len(np.unique(got)) > 20
    np.testing.assert_array_equal(got, want)


def _hwio(rng, cin, co):
    return rng.integers(-127, 128, (3, 3, cin, co), dtype=np.int64).astype(np.int8)


@pytest.mark.parametrize("co", [16, 64, 72, 256])
@pytest.mark.parametrize("cin", [3, 5, 64, 40])
def test_pack_weights_wgmma_round_trips(rng, cin, co):
    """unpack_weights_wgmma gives back the HWIO weights bit for bit, from a
    contiguous int8 [Co tiles, 9 Cin_p N] table."""
    k = _hwio(rng, cin, co)
    p = int8_conv.pack_weights_wgmma(k)
    n = int8_conv.tile_n(co)
    assert p.dtype == np.int8 and p.flags.c_contiguous
    assert p.shape == (-(-co // n), 9 * int8_conv.wgmma_channels(cin) * n)
    np.testing.assert_array_equal(int8_conv.unpack_weights_wgmma(p, cin, co), k)


@pytest.mark.parametrize("cin,co", [(3, 64), (5, 16), (40, 72), (512, 256)])
def test_pack_weights_wgmma_pads_with_zeros(cin, co):
    """Every slot that pack_weights_wgmma adds (Cin to a multiple of 32, Co to
    a multiple of the channel tile) is zero: all-ones weights leave exactly
    9 Cin Co ones."""
    p = int8_conv.pack_weights_wgmma(np.ones((3, 3, cin, co), np.int8))
    assert int(np.count_nonzero(p)) == 9 * cin * co == int(p.astype(np.int64).sum())


def test_pack_weights_wgmma_follows_the_descriptor_order(rng):
    """Element (dy, dx, ci, o) sits where the kernel's wgmma B descriptor
    reads it: channel tile o // N; then 9 x 32 N per earlier 32-channel step
    and 32 N per earlier tap of its own step; 128 per earlier core matrix
    (two k halves of 16 channels per group of 8 output channels); 16 per
    row; ci % 16."""
    cin, co = 40, 72  # N 128, Cin_p 64: two steps, the last one padded
    k = _hwio(rng, cin, co)
    p = int8_conv.pack_weights_wgmma(k)
    n = int8_conv.tile_n(co)
    assert (n, int8_conv.wgmma_channels(cin)) == (128, 64)
    o = np.arange(co)[None, :]
    ci = np.arange(cin)[:, None]
    o_n, kg = o % n, ci % 32 // 16
    for tap in range(9):
        at = ((ci // 32 * 9 + tap) * n * 32 + (o_n // 8 * 2 + kg) * 128 + o_n % 8 * 16 + ci % 16)
        np.testing.assert_array_equal(p[o // n, at], k[tap // 3, tap % 3])
    assert p[0, 9 * 32 * n + 4 * 32 * n + 2 * 128 + 5 * 16 + 7] == k[1, 1, 32 + 7, 8 + 5]


@pytest.mark.parametrize("ho,wo,stride_h,tile", [
    (128, 512, 1, (16, 16)), (32, 128, 1, (16, 16)), (16, 64, 1, (16, 16)),  # surface tower
    (128, 514, 1, (32, 8)), (32, 130, 1, (32, 8)), (16, 66, 1, (16, 16)),  # overhead tower
    (8, 64, 2, (8, 32)), (4, 64, 2, (8, 32)), (8, 68, 2, (8, 32)), (4, 66, 2, (8, 32)),  # head
    (4, 64, 1, (8, 32)),  # conv_27
    (9, 35, 2, (16, 16)), (5, 9, 2, (8, 32)),  # a tie goes to the smaller halo: 17 x 34 < 33 x 18
])
def test_tile_shape_pads_least(ho, wo, stride_h, tile):
    assert int8_conv.tile_shape(ho, wo, stride_h) == tile
    assert [int8_conv.wgmma_channels(c) for c in (3, 5, 32, 40, 512)] == [32, 32, 32, 64, 512]
    assert [int8_conv.tile_n(c) for c in (4, 16, 20, 64, 72, 512)] == [16, 16, 64, 64, 128, 128]


def test_cpu_conv_ignores_the_kernel_table(rng):
    """On CPU tensors the wrappers compute the plain version from ``w``,
    with or without the kernel's table; no launch is counted."""
    x = torch.from_numpy(rng.integers(-127, 128, (2, 6, 7, 5), dtype=np.int64).astype(np.int8))
    k = _hwio(rng, 5, 16)
    w = torch.from_numpy(int8_conv.pack_weights(k))
    wg = torch.from_numpy(int8_conv.pack_weights_wgmma(k))
    bias_q, m = torch.zeros(16, dtype=torch.int32), torch.full((16,), 1e-4)
    before = int8_conv.launches
    want = int8_conv.conv3x3_int8_plain(x, w, bias_q, m, 2, 0)
    for table in (None, wg):
        got = int8_conv.conv3x3_int8(x, w, bias_q, m, 2, 0, True, table)
        assert torch.equal(got, want)
        torch.testing.assert_close(
            int8_conv.conv3x3_int8_dequant(x, w, m, m, 1, 1, table),
            int8_conv.conv3x3_int8_dequant_plain(x, w, m, m, 1, 1), rtol=0, atol=0)
    assert int8_conv.launches == before
