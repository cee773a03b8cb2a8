"""The port's int8 profiling harness (witw_tpu_torch/exp) against the Pallas
TPU kernels it replaces, on the CPU.

Each port function's plain version (what its wrapper computes on CPU
tensors, and what its CUDA kernel is held against on the card) runs on the
same numpy inputs as the JAX function under ``force_tpu_interpret_mode()``:
- ``exp/int8_isolate.py:conv_like`` with its module globals shrunk (B=2,
  H=16, W=32, C=32, N=64, WP8=64; ROWS stays 8): ``full`` bit-equal; the
  stripped modes, whose TPU outputs read uninitialized scratch, agree in
  shape and dtype, and the port's are zeros;
- ``exp/int8_mm_probe.py:mm`` bit-equal, the int32 wraparound included
  (all-127 inputs, K=1152, reps=200); ``mmf`` bit-equal at reps <= 8, where
  every partial sum of the integer-valued bf16 inputs is exact in f32;
- ``exp/mosaic_caps.py``'s four probes bit-equal, on the script's own inputs
  (its ``probe`` is replaced by a recorder while its ``main`` runs).

The three scripts put an absolute checkout path first on ``sys.path`` and
point JAX's compilation cache there when imported; the ``jax_exp`` fixture
imports them and undoes both before anything compiles.
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

from witw_tpu_torch.exp import int8_isolate, int8_mm_probe, mosaic_caps

SMALL = dict(B=2, H=16, W=32, C=32, N=64, WP8=64)
_CACHE_DIR_AT_COLLECTION = jax.config.jax_compilation_cache_dir


@pytest.fixture(scope="module")
def jax_exp():
    """The root ``exp`` scripts ``int8_isolate``, ``int8_mm_probe`` and
    ``mosaic_caps``, with ``sys.path`` and the compilation cache directory
    restored to what they were before the import."""
    path, cache_dir = list(sys.path), jax.config.jax_compilation_cache_dir
    try:
        mods = {name: importlib.import_module(f"exp.{name}")
                for name in ("int8_isolate", "int8_mm_probe", "mosaic_caps")}
    finally:
        sys.path[:] = path
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return types.SimpleNamespace(**mods)


def test_jax_exp_import_keeps_the_compilation_cache(jax_exp):
    assert callable(jax_exp.int8_isolate.conv_like) and callable(jax_exp.mosaic_caps.main)
    assert jax.config.jax_compilation_cache_dir == _CACHE_DIR_AT_COLLECTION


@pytest.fixture(scope="module")
def isolate_case(jax_exp):
    """Inputs at the shrunk shape and the JAX outputs of every mode."""
    jax_isolate = jax_exp.int8_isolate
    rng = np.random.default_rng(0)
    b, h, w, c, n, wp8 = (SMALL[k] for k in ("B", "H", "W", "C", "N", "WP8"))
    xp = rng.integers(-127, 128, (b, h + 2, wp8, c), dtype=np.int64).astype(np.int8)
    wmat = rng.integers(-20, 21, (9 * c, n), dtype=np.int64).astype(np.int8)
    m = np.full((1, n), 0.001, np.float32)
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        for name, value in SMALL.items():
            mp.setattr(jax_isolate, name, value)
        want = {mode: np.asarray(jax_isolate.conv_like(jnp.asarray(xp), jnp.asarray(wmat),
                                                       jnp.asarray(m), mode))
                for mode in int8_isolate.MODES}
    return xp, wmat, m, want


def _port_conv_like(case, mode):
    xp, wmat, m, _ = case
    return int8_isolate.conv_like(torch.from_numpy(xp), torch.from_numpy(wmat),
                                  torch.from_numpy(m), mode, SMALL["W"]).numpy()


def test_conv_like_full_bit_equal(isolate_case):
    want = isolate_case[3]["full"]
    got = _port_conv_like(isolate_case, "full")
    assert got.dtype == np.int8 and got.shape == want.shape == (2, 16, 32, 64)
    assert len(np.unique(got)) > 20  # the requant spreads over [0, 127]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["nopatch", "nodma"])
def test_conv_like_stripped_modes_are_zeros(isolate_case, mode):
    want = isolate_case[3][mode]
    got = _port_conv_like(isolate_case, mode)
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape
    assert not got.any()


def _s8(rng, shape):
    return rng.integers(-127, 128, shape, dtype=np.int64).astype(np.int8)


@pytest.mark.parametrize("case", ["random-reps1", "random-reps3", "wraps"])
def test_mm_bit_equal(jax_exp, case):
    rng = np.random.default_rng(1)
    if case == "wraps":  # 200 * 1152 * 127^2 = 3716121600 > 2^31 - 1
        a, b, reps = np.full((64, 1152), 127, np.int8), np.full((1152, 64), 127, np.int8), 200
    else:
        a, b, reps = _s8(rng, (64, 1152)), _s8(rng, (1152, 128)), int(case[-1])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_exp.int8_mm_probe.mm(jnp.asarray(a), jnp.asarray(b), reps))
    got = int8_mm_probe.mm(torch.from_numpy(a), torch.from_numpy(b), reps).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if case == "wraps":
        assert got[0, 0] == 3716121600 - 2 ** 32


@pytest.mark.parametrize("reps", [1, 8])
def test_mmf_bit_equal(jax_exp, reps):
    rng = np.random.default_rng(2)
    a, b = _s8(rng, (64, 1152)).astype(np.float32), _s8(rng, (1152, 64)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_exp.int8_mm_probe.mmf(jnp.asarray(a, jnp.bfloat16),
                                           jnp.asarray(b, jnp.bfloat16), reps))
    got = int8_mm_probe.mmf(torch.from_numpy(a).to(torch.bfloat16),
                            torch.from_numpy(b).to(torch.bfloat16), reps).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def caps_outputs(jax_exp):
    """{probe name: (numpy inputs, JAX output)} from the script's main()."""
    seen = {}

    def record(name, fn, *args, want=None):
        seen[name] = ([np.array(x) for x in args], np.asarray(fn(*args)))
        assert np.array_equal(seen[name][1], want)

    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        mp.setattr(jax_exp.mosaic_caps, "probe", record)
        jax_exp.mosaic_caps.main()
    return seen


@pytest.mark.parametrize("name,fn", [
    ("T1 lane-half slice s8", mosaic_caps.t1),
    ("T2 lane concat of halves", mosaic_caps.t2),
    ("T3 s8 dot N=64", mosaic_caps.t3),
    ("T4 parity patch build", mosaic_caps.t4),
], ids=["t1", "t2", "t3", "t4"])
def test_caps_bit_equal(caps_outputs, name, fn):
    args, want = caps_outputs[name]
    got = fn(*(torch.from_numpy(x) for x in args)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("module", [int8_isolate, int8_mm_probe, mosaic_caps],
                         ids=["int8_isolate", "int8_mm_probe", "mosaic_caps"])
def test_run_raises_without_a_gpu(module):
    """The probes time the card: without one run() raises, and it refuses
    a CPU device rather than timing plain versions."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.run()
    with pytest.raises(ValueError, match="card"):
        module.run(torch.device("cpu"))
