"""Kernel C of the port's static-int8 towers (witw_tpu_torch.ops.fused_block2)
on the CPU: its plain version against the Pallas TPU kernels it replaces, and
the kernel's tiling.

- Rows 5 and 6 of the TPU kernel table, ``exp/fused_block2.py:fused_block2``
  and ``exp/fused_block2_v2.py:fused_block2_v2``, run under
  ``force_tpu_interpret_mode()`` at their fixed [64, 256, 64] input on the
  same numpy data as ``fused_block2`` (whose CPU path is the plain
  version): array-equal, zero and circular width. The Pallas kernels take
  HWIO weights; the port takes ``pack_weights`` and ``pack_weights_wgmma``
  of the same weights.
- ``geometry`` / ``smem_bytes``: the tile count, the halo pitch, stage 1's
  flat M and the shared memory of a block, which the CUDA source's
  constants repeat (its wrapper refuses a library whose size differs).

The two root ``exp`` scripts put an absolute checkout path first on
``sys.path`` and point JAX's compilation cache there when imported; the
``jax_exp`` fixture imports them and undoes both before anything compiles.
"""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import importlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from witw_tpu_torch.ops import fused_block2, int8_conv

ROWS = {"fused_block2": "fused_block2", "fused_block2_v2": "fused_block2_v2"}


@pytest.fixture(scope="module")
def jax_exp():
    """The root ``exp`` scripts of rows 5 and 6, with ``sys.path`` and the
    compilation cache directory restored to what they were before the
    import."""
    path, cache_dir = list(sys.path), jax.config.jax_compilation_cache_dir
    try:
        mods = {name: importlib.import_module(f"exp.{name}") for name in ROWS}
    finally:
        sys.path[:] = path
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return types.SimpleNamespace(**mods)


def _spread(rng, acc):
    """int32 biases and f32 requant scales that spread ReLU'd outputs of the
    int32 accumulator ``acc`` [..., 128] over [0, 127]."""
    std = float(acc.to(torch.float64).std())
    bias = rng.integers(-int(std / 2), int(std / 2), 128).astype(np.int32)
    m = (rng.uniform(20.0, 60.0, 128) / std).astype(np.float32)
    return bias, m


def _case(seed):
    """x int8 [1, 64, 256, 64] in [0, 127] (a ReLU'd pool-1 output), HWIO
    weights in [-20, 20], and tables fitted to this data's accumulators."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 128, (1, 64, 256, 64), dtype=np.int64).astype(np.int8)
    w1 = rng.integers(-20, 21, (3, 3, 64, 128), dtype=np.int64).astype(np.int8)
    w2 = rng.integers(-20, 21, (3, 3, 128, 128), dtype=np.int64).astype(np.int8)
    p1 = torch.from_numpy(int8_conv.pack_weights(w1))
    b1, m1 = _spread(rng, int8_conv.conv3x3_int8_acc_plain(torch.from_numpy(x), p1))
    y1 = int8_conv.conv3x3_int8_plain(torch.from_numpy(x), p1, torch.from_numpy(b1),
                                      torch.from_numpy(m1))
    p2 = torch.from_numpy(int8_conv.pack_weights(w2))
    b2, m2 = _spread(rng, int8_conv.conv3x3_int8_acc_plain(y1, p2))
    return x, w1, b1, m1, w2, b2, m2


@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("row", ROWS)
def test_plain_equals_pallas_rows_5_6(jax_exp, row, circular):
    x, w1, b1, m1, w2, b2, m2 = _case(5 + int(circular))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(getattr(getattr(jax_exp, row), ROWS[row])(
            *(jnp.asarray(a) for a in (x, w1, b1, m1, w2, b2, m2)), circular=circular))
    t = torch.from_numpy
    got = fused_block2.fused_block2(
        t(x), t(int8_conv.pack_weights(w1)), t(b1), t(m1), t(int8_conv.pack_weights(w2)), t(b2),
        t(m2), circular=circular, w1_wgmma=t(int8_conv.pack_weights_wgmma(w1)),
        w2_wgmma=t(int8_conv.pack_weights_wgmma(w2)))
    assert got.dtype == torch.int8 and got.shape == want.shape == (1, 32, 128, 128)
    assert 0.05 < (want > 0).mean() < 0.95 and len(np.unique(want)) > 100  # outputs spread
    np.testing.assert_array_equal(got.numpy(), want)


def test_geometry_of_the_main_path():
    """Block 2 of the CVUSA surface tower at batch 128: 8192 tiles of 8 x 8
    pool outputs; stage 1 computes 18 rows of the 20-pixel halo pitch as 6
    m64 blocks; a block's shared memory fits the card's 232,448 bytes."""
    g = fused_block2.geometry(128, 64, 256)
    assert g == {"tiles": 128 * 4 * 16, "halo_pitch": 20, "stage1_m": 384,
                 "smem_bytes": 226896}
    y1 = fused_block2.Y1_SIDE
    assert y1 == fused_block2.TILE + 2 and fused_block2.HALO_PITCH == y1 + 2
    assert (y1 - 1) * fused_block2.HALO_PITCH + y1 <= g["stage1_m"] < (y1 - 1) * 20 + y1 + 64
    assert g["stage1_m"] % 64 == 0
    assert g["smem_bytes"] <= fused_block2.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("b,h,w,tiles", [
    (1, 2, 2, 1),       # one pool output
    (1, 17, 33, 2),     # 8 x 16 pool outputs: the odd row and column are dropped
    (3, 9, 3, 3),       # 4 x 1 pool outputs per image
    (2, 64, 100, 2 * 4 * 7),  # 50 pool columns: a ragged last column tile
    (2, 1, 64, 0),      # no pool row
])
def test_geometry_counts_tiles(b, h, w, tiles):
    assert fused_block2.geometry(b, h, w)["tiles"] == tiles


def test_cpu_block2_ignores_the_kernel_tables():
    """On CPU tensors the wgmma tables are not read: the same result with or
    without them, and with a wrong one."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 128, (1, 6, 10, 64)).astype(np.int8))
    w1 = rng.integers(-20, 21, (3, 3, 64, 128)).astype(np.int8)
    w2 = rng.integers(-20, 21, (3, 3, 128, 128)).astype(np.int8)
    args = (x, torch.from_numpy(int8_conv.pack_weights(w1)), torch.zeros(128, dtype=torch.int32),
            torch.full((128,), 1e-4), torch.from_numpy(int8_conv.pack_weights(w2)),
            torch.zeros(128, dtype=torch.int32), torch.full((128,), 2e-4))
    want = fused_block2.fused_block2(*args)
    got = fused_block2.fused_block2(*args, w1_wgmma=torch.zeros(1, 8, dtype=torch.int8),
                                    w2_wgmma=None)
    assert torch.equal(got, want) and want.shape == (1, 3, 5, 128)
