"""The port's host data layer, weight fingerprint and checkpoint import
against witw_tpu on the CPU.

Inputs come from numpy ``default_rng`` (and witw_tpu's synthetic dataset
writer). Each test states its tolerance: equal unless said otherwise.
"""

import dataclasses
import io

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from witw_tpu.configs import dataset_config as jax_dataset_config
from witw_tpu.configs import fov_experiment as jax_fov_experiment
from witw_tpu.data import csv_registry as jcsv
from witw_tpu.data import loader as jloader
from witw_tpu.data import synthetic as jsynth
from witw_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from witw_tpu.train.pipeline import make_pipeline
from witw_tpu.utils.hashing import params_fingerprint as jax_fingerprint
from witw_tpu_torch.configs import dataset_config, fov_experiment
from witw_tpu_torch.data import csv_registry, loader, synthetic
from witw_tpu_torch.models.convert_jax import jax_params_to_state_dict, tower_to_state_dict
from witw_tpu_torch.train.checkpoint import Checkpointer
from witw_tpu_torch.train.pipeline import FovPipeline
from witw_tpu_torch.utils.hashing import params_fingerprint
from witw_tpu_torch.utils.msgpack import restore_flax_state


def _small(cfg):
    return cfg.replace(data=dataclasses.replace(cfg.data, surface_height=32, surface_width_max=64,
                                                overhead_size=32))


@pytest.fixture(scope="module")
def jax_state():
    """witw_tpu's FovPipeline init at a narrow geometry (the params do not
    depend on it)."""
    return make_pipeline(_small(jax_fov_experiment("witw", 70))).init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("schema", ["cvusa", "witw"])
@pytest.mark.parametrize("semantic", [False, True])
def test_read_pair_paths_matches_jax(tmp_path, schema, semantic):
    csv_path = jsynth.write_synthetic_dataset(str(tmp_path), n=5, schema=schema,
                                              surface_hw=(16, 32), overhead_hw=(16, 16))
    # an absolute path and a blank line, which both readers keep / skip
    with open(csv_path) as f:
        lines = f.read().splitlines()
    lines[-1] = lines[-1].replace("overhead/", str(tmp_path / "overhead") + "/")
    with open(csv_path, "w") as f:
        f.write("\n".join(lines[:2] + [""] + lines[2:]) + "\n")
    name = "cvusa" if schema == "cvusa" else "witw"
    want = jcsv.read_pair_paths(jax_dataset_config(name, semantic), csv_path)
    got = csv_registry.read_pair_paths(dataset_config(name, semantic), csv_path)
    assert got == want and len(got) == 5
    assert all(p.endswith(".tif") == semantic for pair in got for p in pair)
    base = str(tmp_path / "elsewhere")
    assert (csv_registry.read_pair_paths(dataset_config(name, semantic), csv_path, base)
            == jcsv.read_pair_paths(jax_dataset_config(name, semantic), csv_path, base))


def test_write_synthetic_dataset_matches_jax(tmp_path):
    for schema in ("cvusa", "witw"):
        a = jsynth.write_synthetic_dataset(str(tmp_path / f"j{schema}"), n=3, schema=schema,
                                           surface_hw=(16, 32), overhead_hw=(16, 16), seed=4)
        b = synthetic.write_synthetic_dataset(str(tmp_path / f"t{schema}"), n=3, schema=schema,
                                              surface_hw=(16, 32), overhead_hw=(16, 16), seed=4)
        assert open(a).read() == open(b).read()
        for rel in ("surface/00002.jpg", "overhead/00002.png"):
            pa = str(tmp_path / f"j{schema}" / rel)
            pb = str(tmp_path / f"t{schema}" / rel)
            np.testing.assert_array_equal(loader.decode_image(pb), jloader.decode_image(pa))


@pytest.mark.parametrize("ext,mode", [(".png", "RGB"), (".jpg", "RGB"), (".png", "L"), (".png", "RGBA"),
                                      (".tif", "RGB")])
def test_decode_image_matches_jax(tmp_path, rng, ext, mode):
    arr = rng.integers(0, 256, (9, 13, len(mode)), dtype=np.uint8)
    path = str(tmp_path / f"img{ext}")
    Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(path)
    got, want = loader.decode_image(path), jloader.decode_image(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
def test_decode_image_bytes_matches_the_daemons_pil_decode(rng, mode):
    """The daemon's request decode: witw_tpu's serve.py reads the bytes with
    PIL, convert("RGB"). PNG is lossless, so the decoders agree exactly."""
    arr = rng.integers(0, 256, (11, 7, len(mode)), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(buf, format="PNG")
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"), np.float32)
    np.testing.assert_array_equal(loader.decode_image_bytes(buf.getvalue()), want)


@pytest.mark.parametrize("src,dst", [((100, 200), (128, 99)), ((256, 256), (32, 32)),
                                     ((37, 53), (80, 71)), ((64, 48), (64, 17))])
@pytest.mark.parametrize("channels", [3, 5])
def test_resize_host_matches_jax_cv2(rng, src, dst, channels):
    """Within 1e-3 on the 0-255 scale of witw_tpu's cv2 INTER_LINEAR resize
    (cv2 computes its weights in f32, the port in f64)."""
    x = rng.uniform(0, 255, src + (channels,)).astype(np.float32)
    got, want = loader.resize_host(x, *dst), jloader.resize_host(x, *dst)
    assert got.shape == want.shape == dst + (channels,) and got.dtype == np.float32
    assert got.flags["C_CONTIGUOUS"]  # as cv2's; the int8 kernels take only contiguous inputs
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert loader.resize_host(x, *src) is x


def test_prefetch_iter_order_errors_and_depth_zero():
    assert list(loader.prefetch_iter(iter(range(50)), depth=3)) == list(range(50))
    it = iter(range(4))
    assert loader.prefetch_iter(it, depth=0) is it

    def broken():
        yield 1
        raise KeyError("producer failed")

    got = []
    with pytest.raises(KeyError, match="producer failed"):
        for item in loader.prefetch_iter(broken(), depth=2):
            got.append(item)
    assert got == [1]


def test_params_fingerprint_matches_jax(jax_state):
    params = jax.tree.map(np.asarray, jax_state.params)
    port = jax_params_to_state_dict(params)
    for tower in ("surface", "overhead"):
        want = jax_fingerprint(jax_state.params[tower])
        assert params_fingerprint(port[tower]) == want
        assert params_fingerprint(params[tower]) == want  # the flax-layout tree itself
    assert params_fingerprint(port["surface"]) != params_fingerprint(port["overhead"])
    moved = {k: v.clone() for k, v in port["overhead"].items()}
    moved["conv_27.bias"][0] += 1.0
    assert params_fingerprint(moved) != params_fingerprint(port["overhead"])


def test_checkpoint_written_by_jax_restores_into_port_params(tmp_path, jax_state):
    """A flax msgpack checkpoint written by witw_tpu's Checkpointer restores
    into the port's params bit for bit (and its step); the port's own .pt
    wins where both exist. The training resume does not take it: exists()
    counts only .pt files, so restore_latest finds no resume point in a
    witw_tpu checkpoint directory."""
    jax_state = jax_state.replace(step=jax.numpy.asarray(7, jax.numpy.int32))
    JaxCheckpointer(str(tmp_path)).save("best", jax_state)
    tree = restore_flax_state(open(tmp_path / "best.msgpack", "rb").read())
    assert sorted(tree) == ["batch_stats", "opt_state", "params", "step"]

    pipeline = FovPipeline(_small(fov_experiment("witw", 70)), "cpu")
    state = pipeline.init_state(torch.Generator().manual_seed(1))
    ckpt = Checkpointer(str(tmp_path))
    assert not ckpt.exists("best")
    ckpt.restore("best", state)
    assert state.step == 7
    for tower in ("surface", "overhead"):
        want = tower_to_state_dict(jax.tree.map(np.asarray, jax_state.params[tower]))
        assert set(state.params[tower]) == set(want)
        for k, v in want.items():
            assert torch.equal(state.params[tower][k], v), (tower, k)

    JaxCheckpointer(str(tmp_path)).save("latest", jax_state)
    assert (tmp_path / "latest.msgpack").exists() and not ckpt.exists("latest")
    assert ckpt.restore_latest(pipeline.init_state(torch.Generator().manual_seed(1))) is None

    other = pipeline.init_state(torch.Generator().manual_seed(2))
    ckpt.save("best", other)
    assert ckpt.exists("best")
    again = ckpt.restore("best", pipeline.init_state(torch.Generator().manual_seed(1)))
    assert torch.equal(again.params["surface"]["vgg.conv_0.weight"],
                       other.params["surface"]["vgg.conv_0.weight"])
