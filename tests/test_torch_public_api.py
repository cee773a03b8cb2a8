"""The port's public names against witw_tpu's, on the CPU.

- The functions the port adds for the last of witw_tpu's public names
  (``ops.image.resize_bilinear``, ``match.correlation.orientation_estimate``,
  ``match.distance.match_scores``, the materialized oracle of
  ``match.reference_impl``, ``FovGalleryEvaluator.metrics`` and
  ``TrainState.trainable_params``), each held against its witw_tpu
  counterpart on the same seeded numpy inputs.
- An AST check against drift, which imports neither package: every public
  top-level name and public class method of each witw_tpu module exists in
  the port's counterpart module (a name the port imports there counts, and
  so does a method a port class inherits), and each subpackage's
  ``__all__`` equals witw_tpu's. The exceptions are the tables below, each
  with its reason.
- Importing the seven subpackages with JAX and witw_tpu made unimportable
  resolves every exported name and builds or loads no CUDA library.
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from witw_tpu.evaluation.gallery import FovGalleryEvaluator as JaxEvaluator
from witw_tpu.match import correlation as j_corr
from witw_tpu.match import distance as j_dist
from witw_tpu.match import reference_impl as j_ref
from witw_tpu.ops import image as j_image
from witw_tpu.train.pipeline import TrainState as JaxTrainState
from witw_tpu_torch.evaluation.gallery import FovGalleryEvaluator
from witw_tpu_torch.match import correlation, distance, reference_impl
from witw_tpu_torch.ops import image
from witw_tpu_torch.train.pipeline import TrainState

REPO = Path(__file__).resolve().parent.parent
REF, PORT = REPO / "witw_tpu", REPO / "witw_tpu_torch"
SUBPACKAGES = ("data", "evaluation", "match", "models", "ops", "train", "utils")


# --- the added functions against witw_tpu --------------------------------

def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp (8 significant bits) at each value of ``x``."""
    exp = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(exp - 7)


@pytest.mark.parametrize("shape, size, dtype", [
    ((2, 7, 9, 3), (14, 18), "float32"),  # NHWC, up by 2
    ((12, 10, 3), (5, 4), "float32"),  # HWC, down by 2.4 and 2.5
    ((2, 10, 15, 3), (7, 23), "float32"),  # non-integer: down in H, up in W
    ((6, 8, 3), (6, 8), "float32"),  # identity
    ((2, 9, 7, 3), (13, 5), "uint8"),  # pixels come back float32
    ((11, 6, 3), (4, 15), "uint8"),
    ((2, 8, 12, 3), (20, 9), "bfloat16"),  # kept bf16
    ((8, 12), (4, 6), "float32"),  # neither HWC nor NHWC
], ids=["nhwc_up", "hwc_down", "nhwc_non_integer", "hwc_identity", "nhwc_uint8",
        "hwc_uint8", "nhwc_bf16", "rank2_raises"])
def test_resize_bilinear_matches_reference(rng, shape, size, dtype):
    """Half-pixel centres, no antialias: torch's clamped source index and
    JAX's renormalized triangle weights give the same edges. f32 within
    1e-4 on [0, 255] data; bf16 within one bf16 ulp."""
    x = rng.uniform(0, 255, shape)
    if dtype == "uint8":
        x_np, x_t = x.astype(np.uint8), torch.from_numpy(x.astype(np.uint8))
    else:
        x_np = x.astype(np.float32)
        x_t = torch.from_numpy(x_np).to(getattr(torch, dtype))
    x_j = jnp.asarray(x_np).astype(jnp.bfloat16 if dtype == "bfloat16" else x_np.dtype)
    if len(shape) == 2:
        with pytest.raises(ValueError, match="expected HWC or NHWC"):
            j_image.resize_bilinear(x_j, *size)
        with pytest.raises(ValueError, match="expected HWC or NHWC"):
            image.resize_bilinear(x_t, *size)
        return
    want = j_image.resize_bilinear(x_j, *size)
    got = image.resize_bilinear(x_t, *size)
    assert tuple(got.shape) == want.shape == shape[:-3] + size + shape[-1:]
    assert got.dtype == {"uint8": torch.float32, "float32": torch.float32,
                         "bfloat16": torch.bfloat16}[dtype]
    assert str(want.dtype) == str(got.dtype).removeprefix("torch.")
    got_np = got.to(torch.float32).numpy()
    want_np = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        assert np.all(np.abs(got_np - want_np) <= _bf16_ulp(want_np))
    else:
        np.testing.assert_allclose(got_np, want_np, rtol=0, atol=1e-4)


def _tie_free_corr(rng, shape):
    corr = rng.standard_normal(shape).astype(np.float32)
    if shape[-1] > 1:
        top = np.sort(corr, axis=-1)
        assert np.all(top[..., -1] - top[..., -2] > 1e-6)  # one maximum per pair
    return corr


@pytest.mark.parametrize("shape", [(3, 5, 16), (1, 1, 1), (4, 7, 64)])
def test_orientation_estimate_matches_reference(rng, shape):
    corr = _tie_free_corr(rng, shape)
    want = np.asarray(j_corr.orientation_estimate(jnp.asarray(corr)))
    got = correlation.orientation_estimate(torch.from_numpy(corr))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temperature", [None, 10.0, 3.5, 0.25])
def test_match_scores_matches_reference(rng, temperature):
    d = rng.uniform(0.0, 4.0, (5, 9)).astype(np.float32)
    kw = {} if temperature is None else {"temperature": temperature}
    want = np.asarray(j_dist.match_scores(jnp.asarray(d), **kw))
    got = distance.match_scores(torch.from_numpy(d), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("bo, bs, h, w, c, sw", [
    (3, 5, 2, 16, 4, 16),  # sw = W: every crop wraps
    (4, 2, 1, 12, 3, 5),
    (2, 3, 4, 64, 16, 16),  # the FOV-90 feature map
    (5, 4, 4, 64, 16, 64),  # the FOV-360 feature map
])
def test_materialized_oracle_matches_reference(rng, bo, bs, h, w, c, sw):
    """The crop at each pair's estimated orientation bit-equal, the chord
    distances within rtol 1e-5 / atol 1e-6; and the port's oracle beside
    its streaming form (chord_distance) on the same correlation."""
    o = rng.standard_normal((bo, h, w, c)).astype(np.float32)
    s = rng.standard_normal((bs, h, sw, c)).astype(np.float32)
    o_j, s_j, o_t, s_t = jnp.asarray(o), jnp.asarray(s), torch.from_numpy(o), torch.from_numpy(s)
    corr = correlation.circular_correlation(o_t, s_t)
    orient = correlation.orientation_estimate(corr)
    crop_j = j_ref.crop_overhead_materialized(o_j, jnp.asarray(orient.numpy()), sw)
    crop_t = reference_impl.crop_overhead_materialized(o_t, orient, sw)
    assert crop_t.dtype == torch.float32 and tuple(crop_t.shape) == (bo, bs, h, sw, c)
    np.testing.assert_array_equal(crop_t.numpy(), np.asarray(crop_j))
    want = np.asarray(j_ref.chord_distance_materialized(crop_j, s_j))
    got = reference_impl.chord_distance_materialized(crop_t, s_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    d_stream, or_stream = distance.chord_distance(o_t, s_t, corr)
    np.testing.assert_array_equal(or_stream.numpy(), orient.numpy())
    np.testing.assert_allclose(got.numpy(), d_stream.numpy(), rtol=1e-5, atol=1e-6)


def _planted(rng, n, h, w, c, sw, noise):
    """Each surface a noisy window of its own overhead map."""
    o = rng.standard_normal((n, h, w, c)).astype(np.float32)
    s = rng.standard_normal((n, h, sw, c)).astype(np.float32)
    for i in range(n):
        cols = (rng.integers(0, w) + np.arange(sw)) % w
        s[i] = o[i][:, cols, :] + noise * s[i]
    return o, s


@pytest.mark.parametrize("use_fused, true_match", [(False, None), (True, None), (False, "given")],
                         ids=["fft", "fused", "true_match"])
def test_gallery_metrics_match_reference(rng, use_fused, true_match):
    """Equal metric dicts on planted pairs whose ranks spread, against
    witw_tpu's evaluator as tests/test_torch_slice.py sets it up."""
    o, s = _planted(rng, 20, 2, 16, 4, 8, noise=1.5)
    tm = None
    if true_match is not None:
        tm = rng.permutation(20)[:12]
        s = s[tm]
    want = JaxEvaluator(query_block=8, gallery_chunk=8).metrics(o, s, tm)
    got = FovGalleryEvaluator(query_block=8, gallery_chunk=8, use_fused=use_fused,
                              device="cpu").metrics(o, s, tm)
    assert 1.0 < want["avg_rank"] and want["top_1"] < 100.0  # a spread of ranks
    assert got == want


def test_train_state_trainable_params():
    params = {"surface": {"w": torch.zeros(2)}, "overhead": {"w": torch.ones(3)}}
    opt = torch.optim.Adam([params["surface"]["w"]])
    assert TrainState(0, params, opt).trainable_params() is params
    j_params = {"surface": {"w": jnp.zeros(2)}}
    assert JaxTrainState(jnp.zeros((), jnp.int32), j_params, {}, ()).trainable_params() is j_params


# --- the AST check against drift -----------------------------------------

# witw_tpu modules with no counterpart (ROADMAP.md's do-not-port list).
NO_COUNTERPART = {
    "utils/platform.py": "picks the JAX platform; the port has no JAX and its entry points "
                         "take a device",
    "ops/pallas/__init__.py": "the Pallas package marker; its one export's counterpart is "
                              "ops/fused_match.py, the wrapper of csrc/fused_match.cu",
    "ops/pallas/fused_match.py": "the Pallas kernel; its counterpart is ops/fused_match.py, "
                                 "the wrapper of csrc/fused_match.cu",
}
# Public names of witw_tpu modules with no counterpart in the port's module.
NOT_PORTED = {
    ("parallel/mesh.py", "batch_sharding"): "builds a jax NamedSharding; the port places "
                                            "tensors itself (parallel.shard_batch)",
    ("parallel/mesh.py", "gallery_sharding"): "builds a jax NamedSharding; the port places "
                                              "tensors itself (parallel.gallery_shards)",
    ("parallel/mesh.py", "replicated_sharding"): "builds a jax NamedSharding; the port places "
                                                 "tensors itself (parallel.replicate)",
    ("models/quantize.py", "w2d_kernel"): "block2_w2d's table, a TPU layout variant that is "
                                          "bit-exact with the default (tests/test_quantize.py)",
}
# Counterparts under another name: witw_tpu name -> the port's.
RENAMED = {("models/baseline.py", "TorchBatchNorm"): "BatchNorm"}
# Differences between a subpackage's __all__ and witw_tpu's: (dropped, added).
ALL_DIFFERS = {
    "parallel": (("batch_sharding", "replicated_sharding", "gallery_sharding"),
                 ("DATA_AXIS", "GALLERY_AXIS", "GlobalBatch", "Mesh", "Shard", "gallery_shards",
                  "placement", "process_count", "process_index", "replicate")),
    "utils": ((), ("span", "spans", "reset")),
    "configs": ((), ("Sample4GeoModelConfig", "sample4geo_experiment")),
}
ALL_DIFFERS_WHY = ("the NamedSharding functions of NOT_PORTED are dropped; the port exports the "
                   "mesh and placement helpers that take their place; utils adds the program's "
                   "spans, which witw_tpu does not have; configs adds the Sample4Geo preset "
                   "and model config: the port's own family; witw_tpu has no ConvNeXt")


def _top_level(body):
    """Statements of a module body, into top-level if / try / with blocks."""
    for node in body:
        if isinstance(node, (ast.If, ast.Try, ast.With)):
            yield from _top_level(node.body)
            yield from _top_level(getattr(node, "orelse", []))
            for handler in getattr(node, "handlers", []):
                yield from _top_level(handler.body)
            yield from _top_level(getattr(node, "finalbody", []))
        else:
            yield node


def _names(tree):
    """(defined {name: node}, imported {name: (module, original name)})."""
    defined, imported = {}, {}
    for node in _top_level(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defined[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        defined[n.id] = node
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                imported[a.asname or a.name] = (node.module, a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                imported[a.asname or a.name.split(".")[0]] = (a.name, None)
    return defined, imported


def _parse(path: Path):
    return _names(ast.parse(path.read_text()))


def _methods(cls: ast.ClassDef):
    return {n.name for n in cls.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _port_methods(path: Path, cls_name: str) -> set:
    """Methods of a port class, its bases' included (bases found in its
    module or imported there from the port)."""
    defined, imported = _parse(path)
    if cls_name in imported:
        module, orig = imported[cls_name]
        if not module or not module.startswith("witw_tpu_torch."):
            return set()
        return _port_methods(_module_path(module), orig)
    cls = defined.get(cls_name)
    if not isinstance(cls, ast.ClassDef):
        return set()
    out = _methods(cls)
    for base in cls.bases:
        if isinstance(base, ast.Name):
            out |= _port_methods(path, base.id)
    return out


def _module_path(module: str) -> Path:
    path = REPO.joinpath(*module.split("."))
    return path / "__init__.py" if path.is_dir() else path.with_suffix(".py")


def _all(path: Path):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return None


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))
REF_PACKAGES = sorted(str(p.parent.relative_to(REF)) for p in REF.rglob("__init__.py")
                      if p.parent != REF and _all(p) is not None
                      and str(p.relative_to(REF)) not in NO_COUNTERPART)


def test_exception_tables_are_current():
    """Each exception names something witw_tpu has and the port lacks."""
    for rel in NO_COUNTERPART:
        assert (REF / rel).exists() and not (PORT / rel).exists(), rel
    for (rel, name), why in NOT_PORTED.items():
        assert why and name in _parse(REF / rel)[0], (rel, name)
        assert name not in {**_parse(PORT / rel)[0], **_parse(PORT / rel)[1]}, (rel, name)
    for (rel, name), port_name in RENAMED.items():
        assert name in _parse(REF / rel)[0] and name not in _parse(PORT / rel)[0]
        assert isinstance(_parse(PORT / rel)[0].get(port_name), ast.ClassDef)
    assert set(SUBPACKAGES) <= set(REF_PACKAGES) and ALL_DIFFERS_WHY


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    """witw_tpu/<rel>'s public top-level names and its public classes'
    public methods exist in witw_tpu_torch/<rel>."""
    if rel in NO_COUNTERPART:
        assert not (PORT / rel).exists()
        return
    assert (PORT / rel).exists(), f"witw_tpu_torch/{rel} is missing"
    ref_defined, _ = _parse(REF / rel)
    port_defined, port_imported = _parse(PORT / rel)
    missing = []
    for name, node in ref_defined.items():
        if name.startswith("_") or (rel, name) in NOT_PORTED:
            continue
        port_name = RENAMED.get((rel, name), name)
        if port_name not in port_defined and port_name not in port_imported:
            missing.append(name)
        elif isinstance(node, ast.ClassDef):
            have = _port_methods(PORT / rel, port_name)
            missing += [f"{name}.{m}" for m in sorted(_methods(node))
                        if not m.startswith("_") and m not in have]
    assert not missing, f"witw_tpu_torch/{rel} lacks {missing}"


@pytest.mark.parametrize("package", REF_PACKAGES)
def test_subpackage_all_matches_reference(package):
    want = _all(REF / package / "__init__.py")
    got = _all(PORT / package / "__init__.py")
    dropped, added = ALL_DIFFERS.get(package, ((), ()))
    assert got is not None, f"witw_tpu_torch/{package}/__init__.py has no __all__"
    assert [n for n in got if n not in added] == [n for n in want if n not in dropped]
    assert set(added) <= set(got) and set(dropped) <= set(want)


def test_subpackages_import_without_jax_or_kernels():
    """The seven subpackages import with JAX and witw_tpu made unimportable,
    every name of their __all__ resolves, no banned module comes in (as
    tests/test_torch_slice.py bans them) and no CUDA library is built or
    loaded."""
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["witw_tpu"] = None
        for m in {SUBPACKAGES!r}:
            mod = importlib.import_module("witw_tpu_torch." + m)
            unresolved = [n for n in mod.__all__ if not hasattr(mod, n)]
            assert not unresolved, (m, unresolved)
        from witw_tpu_torch.kernels.build import load_library
        assert load_library.cache_info().currsize == 0, load_library.cache_info()
        banned = ("jax", "jaxlib", "flax", "optax", "grain", "pandas", "PIL", "witw_tpu",
                  "exp", "imageio", "cv2", "yaml")
        bad = sorted(m for m, mod in sys.modules.items()
                     if m.split(".")[0] in banned and mod is not None)
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"
