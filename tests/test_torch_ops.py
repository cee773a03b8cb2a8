"""Preprocessing ops of the PyTorch port against witw_tpu on the CPU.

Same numpy inputs through both; tolerance rtol 1e-5, atol 1e-4 on 0-255
scale values (f32 roundoff of the affine and bilinear arithmetic, taken in
another order by each framework). Index-only ops and the numpy table
builders must be exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from witw_tpu.ops import fov as jfov
from witw_tpu.ops import image as jimage
from witw_tpu.ops import polar as jpolar
from witw_tpu_torch.ops import fov as tfov
from witw_tpu_torch.ops import image as timage
from witw_tpu_torch.ops import polar as tpolar

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
MEAN5 = MEAN + (0.45, 0.45)
STD5 = STD + (0.22, 0.22)


@pytest.mark.parametrize("width", [10, 16])
def test_fov_crop_matches_jax(rng, width):
    x = rng.uniform(0, 255, (3, 4, 16, 3)).astype(np.float32)
    starts = np.array([0, 7, 15], np.int32)
    want = np.asarray(jfov.fov_crop(jnp.asarray(x), jnp.asarray(starts), width))
    got = tfov.fov_crop(torch.from_numpy(x), torch.from_numpy(starts), width).numpy()
    np.testing.assert_array_equal(got, want)


def test_random_fov_starts_seeded_and_in_range():
    a = tfov.random_fov_starts(torch.Generator().manual_seed(3), 64, 512)
    b = tfov.random_fov_starts(torch.Generator().manual_seed(3), 64, 512)
    assert a.shape == (64,)
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < 512


@pytest.mark.parametrize("channels,scale_channels", [(3, None), (5, 3)])
def test_normalize_images_matches_jax(rng, channels, scale_channels):
    mean, std = (MEAN, STD) if channels == 3 else (MEAN5, STD5)
    x = rng.uniform(0, 255, (2, 8, 12, channels)).astype(np.float32)
    want = np.asarray(jimage.normalize_images(jnp.asarray(x), mean, std, scale_channels))
    got = timage.normalize_images(torch.from_numpy(x), mean, std, scale_channels).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("channels,scale_channels", [(3, None), (5, 3)])
def test_normalize_images_masked_bias_matches_jax(rng, channels, scale_channels):
    mean, std = (MEAN, STD) if channels == 3 else (MEAN5, STD5)
    x = rng.uniform(0, 255, (2, 8, 12, channels)).astype(np.float32)
    mask = (rng.uniform(size=(8, 12)) > 0.2).astype(np.float32)
    want = np.asarray(jimage.normalize_images_masked_bias(
        jnp.asarray(x), mean, std, jnp.asarray(mask), scale_channels))
    got = timage.normalize_images_masked_bias(
        torch.from_numpy(x), mean, std, torch.from_numpy(mask), scale_channels).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _per_call_constants(c, mean, std, scale_channels):
    """The constants as the normalization built them on every call before
    they were cached: (scale, mean_t, std_t)."""
    sc = c if scale_channels is None else scale_channels
    scale = torch.where(torch.arange(c) < sc, torch.tensor(1.0 / 255.0, dtype=torch.float32),
                        torch.tensor(1.0, dtype=torch.float32))
    return (scale, torch.tensor(mean, dtype=torch.float32),
            torch.tensor(std, dtype=torch.float32))


@pytest.mark.parametrize("fn", ["normalize_images", "normalize_images_masked_bias",
                                "denormalize_images"])
@pytest.mark.parametrize("channels,scale_channels", [(3, None), (5, 3)])
def test_normalization_bit_equal_to_per_call_formula(rng, fn, channels, scale_channels):
    """The cached constants give the same bits as the per-call formula, on a
    cold cache and on a warm one."""
    mean, std = (MEAN, STD) if channels == 3 else (MEAN5, STD5)
    x = torch.from_numpy(rng.uniform(0, 255, (2, 8, 12, channels)).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(8, 12)) > 0.2).astype(np.float32))
    scale, mean_t, std_t = _per_call_constants(channels, mean, std, scale_channels)
    if fn == "normalize_images":
        want = (x * scale - mean_t) / std_t
        call = lambda: timage.normalize_images(x, mean, std, scale_channels)  # noqa: E731
    elif fn == "normalize_images_masked_bias":
        k = scale / std_t
        b = -mean_t / std_t
        want = x * k + mask[..., None] * b
        call = lambda: timage.normalize_images_masked_bias(  # noqa: E731
            x, mean, std, mask, scale_channels)
    else:
        want = x * std_t + mean_t
        call = lambda: timage.denormalize_images(x, mean, std)  # noqa: E731
    timage._constants.cache_clear()
    for _ in range(2):
        got = call()
        assert got.dtype == torch.float32 and torch.equal(got, want)


def test_normalization_constants_built_once_per_key(rng):
    """Calls with a key already built upload nothing; a new mean, channel
    count or ``scale_channels`` builds exactly one new set, and every
    function shares the set of its key."""
    timage._constants.cache_clear()
    x3 = torch.from_numpy(rng.uniform(0, 255, (2, 4, 6, 3)).astype(np.float32))
    x5 = torch.from_numpy(rng.uniform(0, 255, (2, 4, 6, 5)).astype(np.float32))
    mask = torch.ones(4, 6)
    count = timage.constant_uploads
    timage.normalize_images(x3, MEAN, STD)
    assert timage.constant_uploads == count + 1
    for _ in range(3):
        timage.normalize_images(x3, MEAN, STD)
        timage.normalize_images_masked_bias(x3, MEAN, STD, mask)
        timage.denormalize_images(x3, MEAN, STD)
        timage.normalize_images(x3, list(MEAN), np.asarray(STD, np.float64))
    assert timage.constant_uploads == count + 1
    for args, n in (((x3, (0.5, 0.5, 0.5), STD), 2),  # another mean
                    ((x5, MEAN5, STD5), 3),  # another channel count
                    ((x5, MEAN5, STD5, 3), 4)):  # another scale_channels
        for _ in range(2):
            timage.normalize_images(*args)
            timage.normalize_images_masked_bias(*args[:3], mask, *args[3:])
        assert timage.constant_uploads == count + n


def test_normalization_constants_built_in_inference_mode_serve_autograd(rng):
    """Constants first built under ``torch.inference_mode`` (an eval) are
    ordinary tensors: a later step may save them for backward."""
    timage._constants.cache_clear()
    x = torch.from_numpy(rng.uniform(0, 255, (2, 4, 6, 3)).astype(np.float32))
    with torch.inference_mode():
        timage.normalize_images(x, MEAN, STD)
        timage.denormalize_images(x, MEAN, STD)
    assert not any(t.is_inference() for t in timage._constants_for(x, MEAN, STD))
    xg = x.clone().requires_grad_(True)
    timage.normalize_images_masked_bias(xg, MEAN, STD, torch.ones(4, 6)).sum().backward()
    timage.denormalize_images(timage.normalize_images(xg, MEAN, STD), MEAN, STD).sum().backward()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())


@pytest.mark.parametrize("geometry", [(128, 512, 256), (32, 64, 32), (16, 40, 24)])
def test_polar_grid_copy_equals_jax(geometry):
    want = jpolar.polar_grid(*geometry)
    got = tpolar.polar_grid(*geometry)
    np.testing.assert_array_equal(got.idx, want.idx)
    np.testing.assert_array_equal(got.weight, want.weight)
    np.testing.assert_array_equal(got.wsum, want.wsum)
    assert got.out_hw == want.out_hw


@pytest.mark.parametrize("gather", ["float32", "bfloat16"])
def test_polar_transform_production_geometry_matches_jax(rng, gather):
    """256^2 tile -> 128x512 panorama; non-integer pixels so the bf16 gather
    rounds, and both frameworks must round the same way."""
    x = rng.uniform(0, 255, (2, 256, 256, 3)).astype(np.float32)
    want = np.asarray(jpolar.polar_transform(
        jnp.asarray(x), 128, 512, gather_dtype=getattr(jnp, gather)))
    got = tpolar.polar_transform(
        torch.from_numpy(x), 128, 512, gather_dtype=getattr(torch, gather)).numpy()
    assert got.shape == (2, 128, 512, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_polar_transform_single_tile_and_boundary_zeros(rng):
    x = rng.uniform(1, 255, (32, 32, 3)).astype(np.float32)
    got = tpolar.polar_transform(torch.from_numpy(x), 16, 64).numpy()
    want = np.asarray(jpolar.polar_transform(jnp.asarray(x), 16, 64))
    assert got.shape == (16, 64, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    # clip-then-weight: exact-boundary samples are 0, not the border pixel
    boundary = tpolar.polar_grid(16, 64, 32).wsum == 0
    assert boundary.any()
    np.testing.assert_array_equal(got[boundary], 0.0)
