"""The port's offline ``.pth`` converter (witw_tpu_torch.models.convert_torch)
against witw_tpu's, on the CPU.

The ``.pth`` files are built in the test with ``torch.save`` from numpy
``default_rng`` draws (nothing is downloaded): torchvision's VGG16 layout
(``features.N.*`` and a classifier), the reference's FOV-DSM tower layout
(``model.features.N[.layer].*`` with the head convs) and a reference
baseline tower (``module.convN`` / ``module.bnN`` with
``num_batches_tracked``). Both CLIs run through ``main(argv)`` in this
process. The ``.npz`` files must be equal array for array (keys, dtypes,
values); a converted tower's output is held against witw_tpu's tower on
witw_tpu's converted params at the f32 towers' cross-framework tolerances
(FOV-DSM rtol 1e-3, atol 1e-4 as tests/test_torch_models.py; baseline rtol
2e-4, atol 2e-5 as tests/test_torch_baseline.py).
"""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from witw_tpu.configs import BaselineModelConfig as JaxBaselineModelConfig
from witw_tpu.configs import FovDsmModelConfig as JaxFovDsmModelConfig
from witw_tpu.models import FovDsm as JaxFovDsm
from witw_tpu.models import convert_torch as jconv
from witw_tpu.models.baseline import BaselineEncoder as JaxEncoder
from witw_tpu_torch.configs import FovDsmModelConfig, baseline_experiment
from witw_tpu_torch.models import convert_torch as tconv
from witw_tpu_torch.models.backbones.vgg16 import VGG16_CONVS
from witw_tpu_torch.models.baseline import CHANNELS, BaselineEncoder
from witw_tpu_torch.models.convert_jax import tower_to_state_dict
from witw_tpu_torch.models.fov_dsm import HEAD_CONVS, FovDsm

HEAD_IN = {"conv_23": 512, "conv_25": 256, "conv_27": 64}
BASELINE_TILE = 384  # the least side of seven VALID stride-2 convs, rounded up


def _conv(rng, co, ci, k=3):
    fan_in = ci * k * k
    return (rng.standard_normal((co, ci, k, k)) / np.sqrt(fan_in)).astype(np.float32)


def _vgg_state(rng, layout, width=None):
    """A VGG16 / FOV-DSM tower state dict of torch tensors: ``torchvision``
    (features.N.*, a classifier, no head), or ``reference`` (model.features.N,
    convs of blocks 3-4 wrapped as ``.layer.``, the head convs 23 / 25 / 27).
    ``width``: every conv that many channels wide (a small file for the
    converters, which read any widths), else the tower's own."""
    sd, cin = {}, 3
    for idx, co in VGG16_CONVS:
        co = width or co
        key = f"features.{idx}"
        if layout == "reference":
            key = f"model.features.{idx}" + (".layer" if idx >= 10 else "")
        sd[f"{key}.weight"] = torch.from_numpy(_conv(rng, co, cin))
        sd[f"{key}.bias"] = torch.from_numpy(rng.standard_normal(co).astype(np.float32) * 0.1)
        cin = co
    if layout == "torchvision":
        sd["classifier.0.weight"] = torch.zeros(8, 4)
        sd["classifier.0.bias"] = torch.zeros(8)
    else:
        for name, co, _, _ in HEAD_CONVS:
            key = f"model.features.{name.split('_')[1]}.layer"
            co, ci = (width, width) if width else (co, HEAD_IN[name])
            sd[f"{key}.weight"] = torch.from_numpy(_conv(rng, co, ci))
            sd[f"{key}.bias"] = torch.from_numpy(rng.standard_normal(co).astype(np.float32) * 0.1)
    return sd


def _baseline_state(rng, width=None):
    """A reference baseline tower under DataParallel's ``module.`` prefix,
    with BatchNorm's ``num_batches_tracked`` (``width`` as ``_vgg_state``)."""
    sd, cin = {}, 3
    for i, co in enumerate(CHANNELS, 1):
        co = width or co
        sd[f"module.conv{i}.weight"] = torch.from_numpy(_conv(rng, co, cin, 4))
        sd[f"module.conv{i}.bias"] = torch.from_numpy(rng.standard_normal(co).astype(np.float32) * 0.1)
        sd[f"module.bn{i}.weight"] = torch.from_numpy(rng.uniform(0.5, 1.5, co).astype(np.float32))
        sd[f"module.bn{i}.bias"] = torch.from_numpy(rng.standard_normal(co).astype(np.float32) * 0.1)
        sd[f"module.bn{i}.running_mean"] = torch.from_numpy(
            rng.standard_normal(co).astype(np.float32) * 0.1)
        sd[f"module.bn{i}.running_var"] = torch.from_numpy(rng.uniform(0.5, 2.0, co).astype(np.float32))
        sd[f"module.bn{i}.num_batches_tracked"] = torch.tensor(17)
        cin = co
    return sd


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _assert_npz_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_apply(model, params, x):
    return np.asarray(jax.jit(model.apply)({"params": jax.tree.map(jnp.asarray, params)},
                                           jnp.asarray(x)))


@pytest.mark.parametrize("layout,dtype", [("torchvision", torch.float32),
                                          ("reference", torch.float32),
                                          ("reference", torch.float16)],
                         ids=["torchvision", "reference", "reference-float16"])
def test_fov_npz_equals_witw_tpu(tmp_path, rng, layout, dtype):
    """Both CLIs on one ``.pth`` (8 channels a conv: a small file): equal
    npz files, in the ``.pth``'s dtype; each package reads the other's file
    as its own conversion (the port through its weight bridge,
    ``load_converted``, in float32; witw_tpu through ``unflatten``)."""
    src = tmp_path / "vgg.pth"
    torch.save({k: v.to(dtype) for k, v in _vgg_state(rng, layout, width=8).items()}, src)
    tconv.main([str(src), str(tmp_path / "port.npz")])
    jconv.main([str(src), str(tmp_path / "jax.npz")])
    got, want = _npz(tmp_path / "port.npz"), _npz(tmp_path / "jax.npz")
    _assert_npz_equal(got, want)
    assert {v.dtype for v in got.values()} == {torch.empty(0, dtype=dtype).numpy().dtype}
    assert any(k.startswith("conv_23/") for k in want) == (layout == "reference")

    sd = tconv.convert_fov_dsm_state_dict(tconv.load_torch_file(str(src)))
    kept = tconv.convert_fov_dsm_state_dict(tconv.load_torch_file(str(src)), dtype=None)
    from_jax = tconv.load_converted(str(tmp_path / "jax.npz"))
    assert sorted(from_jax) == sorted(sd) == sorted(kept)
    for k, v in sd.items():
        assert v.dtype == torch.float32 and torch.equal(from_jax[k], v), k
        assert kept[k].dtype == dtype and torch.equal(kept[k].float(), v), k
    jtree = jconv.convert_fov_dsm_state_dict(torch.load(src, weights_only=True))
    _assert_npz_equal(jconv._flatten(jconv.unflatten(got)), jconv._flatten(jtree))


def test_converted_fov_tower_matches_witw_tpu(tmp_path, rng):
    """A reference tower checkpoint converted by each package: the port's
    FovDsm on its state dict against witw_tpu's FovDsm on its params, at
    32 x 64, batch 2, zero and circular padding."""
    sd_torch = _vgg_state(rng, "reference")
    sd = tconv.convert_fov_dsm_state_dict(sd_torch)
    params = jconv.convert_fov_dsm_state_dict(sd_torch)
    x = rng.standard_normal((2, 32, 64, 3)).astype(np.float32)
    for circ in (False, True):
        want = _jax_apply(JaxFovDsm(JaxFovDsmModelConfig(compute_dtype="float32"),
                                    circ_padding=circ), params, x)
        model = FovDsm(FovDsmModelConfig(compute_dtype="float32"), circ_padding=circ).eval()
        model.load_state_dict(sd)
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, 1, 8, 16)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_merge_pretrained_vgg_on_semantic_conv_0(rng):
    """torchvision's RGB conv_0 into a 5-channel semantic tower: the first
    three input channels take the RGB weights, channels 3-4 keep the fresh
    init, every other VGG conv is replaced and the head keeps its init; the
    same arrays as witw_tpu's merge on the same trees."""
    tv = _vgg_state(rng, "torchvision")
    fresh = FovDsm(FovDsmModelConfig(compute_dtype="float32", in_channels=5)).state_dict()
    merged = tconv.merge_pretrained_vgg(fresh, tconv.convert_fov_dsm_state_dict(tv))
    w0, src0 = merged["vgg.conv_0.weight"], tv["features.0.weight"]
    assert w0.shape == (64, 5, 3, 3)
    assert torch.equal(w0[:, :3], src0) and torch.equal(w0[:, 3:], fresh["vgg.conv_0.weight"][:, 3:])
    assert torch.equal(merged["vgg.conv_19.weight"], tv["features.19.weight"])
    assert torch.equal(merged["conv_25.weight"], fresh["conv_25.weight"])
    assert not torch.equal(fresh["vgg.conv_0.weight"][:, :3], src0)  # the input was not changed

    from witw_tpu_torch.models.convert_jax import state_dict_to_tower
    want = jconv.merge_pretrained_vgg(state_dict_to_tower(fresh), jconv.convert_fov_dsm_state_dict(tv))
    got = tower_to_state_dict(want)
    assert sorted(got) == sorted(merged)
    for k, v in merged.items():
        assert torch.equal(got[k], v), k

    bad = dict(tconv.convert_fov_dsm_state_dict(tv))
    bad["vgg.conv_2.weight"] = bad["vgg.conv_2.weight"][:32]
    with pytest.raises(ValueError, match="shape mismatch"):
        tconv.merge_pretrained_vgg(fresh, bad)


def test_baseline_npz_and_tower_match_witw_tpu(tmp_path, rng):
    """A reference baseline checkpoint with ``module.`` and
    ``num_batches_tracked``: both CLIs' ``--family baseline`` npz files
    equal (8 channels a conv: a small file), and the port reads witw_tpu's;
    at the tower's widths the port's state dict loads strictly into
    BaselineEncoder (no ``num_batches_tracked``) and its eval-mode tower at
    384², batch 2, matches witw_tpu's on witw_tpu's (params, batch_stats)."""
    small = _baseline_state(rng, width=8)
    src = tmp_path / "surface_best.pth"
    torch.save(small, src)
    tconv.main([str(src), str(tmp_path / "port.npz"), "--family", "baseline"])
    jconv.main([str(src), str(tmp_path / "jax.npz"), "--family", "baseline"])
    _assert_npz_equal(_npz(tmp_path / "port.npz"), _npz(tmp_path / "jax.npz"))
    from_jax = tconv.load_converted(str(tmp_path / "jax.npz"))
    small_sd = tconv.convert_baseline_state_dict(small)
    assert sorted(from_jax) == sorted(small_sd)
    assert all(torch.equal(from_jax[k], v) for k, v in small_sd.items())

    sd_torch = _baseline_state(rng)
    sd = tconv.convert_baseline_state_dict(sd_torch)
    assert not any("num_batches_tracked" in k for k in sd)

    cfg = dataclasses.replace(baseline_experiment().model, compute_dtype="float32")
    model = BaselineEncoder(cfg).eval()
    model.load_state_dict(sd, strict=True)
    params, stats = jconv.convert_baseline_state_dict(sd_torch)
    x = rng.uniform(0, 255, (2, BASELINE_TILE, BASELINE_TILE, 3)).astype(np.float32)
    jm = JaxEncoder(JaxBaselineModelConfig(compute_dtype="float32", conv_precision="highest"))
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": jax.tree.map(jnp.asarray, params),
         "batch_stats": jax.tree.map(jnp.asarray, stats)}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1536)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_converter_rejects_a_missing_vgg_conv(rng):
    sd = _vgg_state(rng, "torchvision")
    del sd["features.7.weight"]
    with pytest.raises(KeyError, match="features.7.weight"):
        tconv.convert_fov_dsm_state_dict(sd)
