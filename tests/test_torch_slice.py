"""The PyTorch port's FOV-DSM inference slice end to end against witw_tpu,
and the port's import boundary.

Raw batch -> distance matrix through both packages on shared weights, f32,
small geometry (32 x 64 panorama, 32^2 tile), heading pinned
(random_orientation=False: the two frameworks draw different random bits):
atol 1e-3 (the towers' f32 bound of rtol 1e-3 / atol 1e-4 on maps, carried
through a normalized distance). Retrieval ranks must be equal, on inputs
whose distances are separated by far more than that bound (checked).
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from witw_tpu.configs import DataConfig, DatasetConfig, ExperimentConfig, FovDsmModelConfig
from witw_tpu.evaluation.gallery import FovGalleryEvaluator as JaxEvaluator
from witw_tpu.match.correlation import circular_correlation
from witw_tpu.match.distance import chord_distance
from witw_tpu.ops.polar import polar_transform
from witw_tpu.train.loop import embed_all as jax_embed_all
from witw_tpu.train.pipeline import FovPipeline as JaxPipeline
from witw_tpu_torch.models.convert_jax import jax_params_to_state_dict
from witw_tpu_torch.ops import fused_match
from witw_tpu_torch.train import loop
from witw_tpu_torch.train.pipeline import FovPipeline

REPO = Path(__file__).resolve().parent.parent


def _cfg(fov=360, random_orientation=False):
    ds = DatasetConfig(name="cvusa", train_csv="", test_csv="", panorama=True)
    data = DataConfig(dataset=ds, surface_height=32, surface_width_max=64,
                      overhead_size=32, fov=fov, random_orientation=random_orientation)
    return ExperimentConfig(data=data, model=FovDsmModelConfig(compute_dtype="float32"))


@pytest.fixture(scope="module")
def jax_state():
    """One flax init shared by every test here: the towers' params do not
    depend on the fov."""
    return jax.jit(JaxPipeline(_cfg(360)).init)(jax.random.PRNGKey(0))


def _shared(cfg, state):
    params = jax_params_to_state_dict(jax.tree.map(np.asarray, state.params))
    return JaxPipeline(cfg), FovPipeline(cfg, "cpu"), params


def _batch(rng, b):
    return {
        "surface": rng.uniform(0, 255, (b, 32, 64, 3)).astype(np.float32),
        "overhead": rng.uniform(0, 255, (b, 32, 32, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("fov", [360, 90])
def test_forward_distance_matches_jax(rng, fov, monkeypatch, jax_state):
    monkeypatch.setattr(fused_match, "launches", 0)
    cfg = _cfg(fov)
    state = jax_state
    jp, tp, params = _shared(cfg, state)
    batch = _batch(rng, 4)

    @jax.jit
    def forward(params, batch):  # __graft_entry__.entry()'s forward
        surface, polar = jp._preprocess(batch, jax.random.PRNGKey(0), train=False)
        s_emb = jp.surface_model.apply({"params": params["surface"]}, surface)
        o_emb = jp.overhead_model.apply({"params": params["overhead"]}, polar)
        d, _ = chord_distance(o_emb, s_emb, circular_correlation(o_emb, s_emb))
        return surface, polar, d

    surface, polar, want = forward(state.params, batch)

    t_surface, t_polar = tp.preprocess(batch)
    np.testing.assert_allclose(t_surface.numpy(), np.asarray(surface), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t_polar.numpy(), np.asarray(polar), rtol=1e-5, atol=1e-4)
    got = tp.forward_distance(params, batch)
    assert got.shape == (4, 4) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    assert fused_match.launches == 0  # CPU tensors take the plain version


def test_random_orientation_is_seeded(rng):
    cfg = _cfg(90, random_orientation=True)
    tp = FovPipeline(cfg, "cpu")
    params = tp.init(torch.Generator().manual_seed(0))
    batch = _batch(rng, 3)
    a = tp.forward_distance(params, batch, torch.Generator().manual_seed(5))
    b = tp.forward_distance(params, batch, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and torch.isfinite(a).all()


def _planted_pairs(rng, n):
    """Blocky overhead tiles, and surfaces that are their own tile's polar
    panorama under growing noise: with one set of tower weights for both
    views, each query's true distance is planted well apart from the rest."""
    coarse = rng.uniform(0, 255, (n, 4, 4, 3))
    over = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2).astype(np.float32)
    pol = np.asarray(polar_transform(jnp.asarray(over), 32, 64))
    noise = np.linspace(0.0, 0.3, n)[:, None, None, None] * 128.0
    surf = np.clip(pol + noise * rng.standard_normal(pol.shape), 0, 255).astype(np.float32)
    return [{"surface": surf[i:i + 6], "overhead": over[i:i + 6]} for i in range(0, n, 6)]


def test_embed_all_and_ranks_match_jax(rng, jax_state):
    cfg = _cfg(360)
    tower = jax_state.params["overhead"]
    state = jax_state.replace(params={"surface": tower, "overhead": tower})
    jp, tp, params = _shared(cfg, state)
    batches = _planted_pairs(rng, 12)

    s_j, o_j = jax_embed_all(jp, state, batches)
    s_t, o_t = loop.embed_all(tp, params, batches)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-3, atol=1e-4)

    d_j = np.asarray(chord_distance(o_j, s_j, circular_correlation(o_j, s_j))[0])
    d_t = fused_match.fused_chord_distance_plain(o_t, s_t)[0].numpy()
    err = np.abs(d_t - d_j).max()
    assert err < 1e-3
    # No rank can flip: every gallery distance is further from its query's
    # threshold than the two packages' distances differ, twice over.
    gap = np.abs(d_j - np.diag(d_j)[None, :])
    np.fill_diagonal(gap, np.inf)
    assert gap.min() > 2 * err

    want = JaxEvaluator(query_block=8, gallery_chunk=8).ranks(o_j, s_j)
    assert len(set(want.tolist())) > 2  # a spread of ranks, not all 1
    metrics, ranks = loop.test_ranks(cfg, tp, batches, params, verbose=False)
    np.testing.assert_array_equal(ranks, want)
    assert metrics == loop.metrics_from_ranks(want)
    assert loop.test(cfg, tp, batches, params, verbose=False) == metrics


def test_port_imports_no_jax():
    """Every module of witw_tpu_torch (its exp probes, the serving modules,
    the data layer, the index, build_index, the daemon, the GeoTIFF binding,
    the heatmap sweep, the metric writer, the CLIs, the SAFA towers, the
    vector index and cvig_safa, and the baseline towers, the synced rotation,
    the orientation maps and cvig_baseline, the config YAML and the .pth
    converter, the device mesh, the collectives and the sharded loader),
    chip_smoke and the profile scripts import with JAX and every witw_tpu
    module made unimportable, and none pulls in flax, optax, grain, the
    pandas/PIL deps of witw_tpu.data, the root exp scripts, PyYAML, or (at
    import time) the image decoders imageio and cv2."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["witw_tpu"] = None
        import witw_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            witw_tpu_torch.__path__, "witw_tpu_torch.")]
        wanted = ["witw_tpu_torch." + m for m in (
            "data.csv_registry", "data.loader", "data.synthetic", "utils.hashing",
            "utils.msgpack", "evaluation.index", "tools.build_index", "tools.serve",
            "tools.geotiff", "tools.cities", "tools.heatmap", "train.metrics", "cli.common",
            "cli.cvig_fov", "cli.cvig_semantic", "models.safa", "evaluation.vector_index",
            "cli.cvig_safa", "models.baseline", "ops.rotation", "ops.orientation_maps",
            "cli.cvig_baseline", "configs.serialize", "models.convert_torch", "parallel",
            "parallel.mesh", "parallel.collectives", "data.grain_loader")]
        assert set(wanted) <= set(names), sorted(set(wanted) - set(names))
        for name in names + ["chip_smoke", "profile_int8", "profile_bf16", "profile_conv",
                             "profile_match", "profile_host"]:
            importlib.import_module(name)
        banned = ("jax", "jaxlib", "flax", "optax", "grain", "pandas", "PIL", "witw_tpu",
                  "exp", "imageio", "cv2", "yaml")
        bad = sorted(m for m, mod in sys.modules.items()
                     if m.split(".")[0] in banned and mod is not None)
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 64


@pytest.mark.parametrize("make", [
    lambda c: c.fov_experiment("cvusa", 360),
    lambda c: c.fov_experiment("cvusa", 90),
    lambda c: c.fov_experiment("witw", 360),
    lambda c: c.fov_experiment("witw", 90),
    lambda c: c.semantic_experiment(),
    lambda c: c.safa_experiment("cvusa", 360),
    lambda c: c.safa_experiment("witw", 70),
    lambda c: c.baseline_experiment("cvusa"),
    lambda c: c.baseline_experiment("witw"),
], ids=["cvusa-360", "cvusa-90", "witw-360", "witw-90", "semantic", "safa-cvusa-360",
        "safa-witw-70", "baseline-cvusa", "baseline-witw"])
def test_port_configs_equal_witw_tpu(make):
    """The port's copy of the configs gives the same presets as witw_tpu's."""
    import witw_tpu.configs as jcfg
    import witw_tpu_torch.configs as tcfg

    got, want = make(tcfg), make(jcfg)
    assert type(got.model).__name__ == type(want.model).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.data.surface_width == want.data.surface_width


def test_chip_smoke_fails_without_a_gpu():
    """On a machine without CUDA the smoke script exits non-zero and prints
    no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "CUDA" in out.stderr
