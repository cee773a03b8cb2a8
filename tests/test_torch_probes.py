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
  (its ``probe`` is replaced by a recorder while its ``main`` runs); the
  plain versions also at kernel C's slab layout and at ragged rows, against
  the script's numpy expressions, and ``caps.cu``'s tiling
  (``mosaic_caps.geometry``).

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


# The redesigned kernels' host-side layout and limits. The wrappers check
# shapes before the device, so their ValueErrors show on CPU tensors.


@pytest.mark.parametrize("c,n", [(32, 64), (128, 128), (64, 96), (32, 32), (96, 256)])
def test_pack_wmat_wgmma_is_kernel_a_table(c, n):
    """conv_like's weight table is ops/int8_conv.pack_weights_wgmma of the
    same weights (kernel A's), and unpacks to them."""
    from witw_tpu_torch.ops import int8_conv

    wmat = _s8(np.random.default_rng(c + n), (9 * c, n))
    got = int8_isolate.pack_wmat_wgmma(torch.from_numpy(wmat)).numpy()
    hwio = int8_isolate.pack_wmat(torch.from_numpy(wmat)).permute(1, 2, 3, 0).numpy()
    np.testing.assert_array_equal(got, int8_conv.pack_weights_wgmma(hwio))
    np.testing.assert_array_equal(int8_conv.unpack_weights_wgmma(got, c, n), hwio)
    assert got.shape == (-(-n // int8_conv.tile_n(n)), 9 * c * int8_conv.tile_n(n))


def _conv_like_args(b=2, h=16, w=32, c=32, n=64, wp=64):
    xp = torch.zeros((b, h + 2, wp, c), dtype=torch.int8)
    wmat = torch.zeros((9 * c, n), dtype=torch.int8)
    return xp, int8_isolate.pack_wmat_wgmma(wmat), torch.full((1, n), 0.001), "full", w


@pytest.mark.parametrize("change,match", [
    ({"mode": "dense"}, "mode"),
    ({"xp": torch.zeros((2, 18, 64, 32), dtype=torch.uint8)}, "int8"),
    ({"m": torch.full((1, 64), 0.001, dtype=torch.float64)}, "float32"),
    ({"xp": torch.zeros((18, 64, 32), dtype=torch.int8)}, "WP, C"),
    ({"xp": torch.zeros((2, 18, 64, 16), dtype=torch.int8)}, "multiples of 32"),
    ({"m": torch.full((1, 48), 0.001)}, "multiples of 32"),
    ({"m": torch.full((1, 8192), 0.001)}, "multiples of 32"),
    ({"w_wgmma": torch.zeros((1, 9 * 32 * 128), dtype=torch.int8)}, "pack_wmat_wgmma"),
    ({"width": 63}, "padded"),
    ({"xp": torch.zeros((2, 2, 64, 32), dtype=torch.int8)}, "padded"),
], ids=["mode", "xp-dtype", "m-dtype", "xp-rank", "c", "n", "n-max", "table", "width", "rows"])
def test_conv_like_kernel_rejects_on_shape(change, match):
    xp, w_wgmma, m, mode, width = _conv_like_args()
    args = {"xp": xp, "w_wgmma": w_wgmma, "m": m, "mode": mode, "width": width, **change}
    with pytest.raises(ValueError, match=match):
        int8_isolate.conv_like_kernel(**args)
    # a valid call reaches the device check
    with pytest.raises(ValueError, match="CUDA"):
        int8_isolate.conv_like_kernel(xp, w_wgmma, m, mode, width)


def test_pack_wmat_wgmma_rejects_unaligned_channels():
    with pytest.raises(ValueError, match="multiples of 32"):
        int8_isolate.pack_wmat_wgmma(torch.zeros((9 * 16, 64), dtype=torch.int8))


@pytest.mark.parametrize("m,n,k_bytes,s8,tile_n,slices", [
    (2048, 128, 1152, True, 64, 4),     # mm at N 128
    (2048, 512, 1152, True, 256, 4),    # mm at N 512
    (2048, 128, 2304, False, 64, 8),    # mmf (bf16 K 1152)
    (256, 64, 128, True, 32, 1),        # t3
    (64, 256, 4096, True, 128, 15),     # a long K: more slices
    (128, 512, 64, False, 128, 1),      # bf16 stays at 128 columns a warpgroup
], ids=["mm-n128", "mm-n512", "mmf", "t3", "long-k", "bf16-wide"])
def test_mm_geometry(m, n, k_bytes, s8, tile_n, slices):
    plan = int8_mm_probe.geometry(m, n, k_bytes, s8)
    assert (plan["tile_n"], plan["slices"]) == (tile_n, slices)
    assert plan["grid"] == (m // 64, n // (2 * tile_n), slices)
    assert (slices - 1) * int8_mm_probe.STEPS * int8_mm_probe.STEP_BYTES < k_bytes
    assert slices * int8_mm_probe.STEPS * int8_mm_probe.STEP_BYTES >= k_bytes


@pytest.mark.parametrize("m,n,k_bytes", [
    (96, 64, 64), (64, 96, 64), (64, 64, 48), (0, 64, 64),
    (64, 2 ** 27, 32),  # more column tiles than the grid takes
    (64, 64, 65536 * 288),  # more slices than the grid takes
], ids=["m", "n", "k", "empty", "grid-n", "grid-k"])
def test_mm_geometry_rejects(m, n, k_bytes):
    with pytest.raises(ValueError):
        int8_mm_probe.geometry(m, n, k_bytes)


@pytest.mark.parametrize("a,bt,reps,match", [
    (torch.zeros((96, 64), dtype=torch.int8), torch.zeros((64, 64), dtype=torch.int8), 1, "multiples"),
    (torch.zeros((64, 48), dtype=torch.int8), torch.zeros((64, 48), dtype=torch.int8), 1, "multiples"),
    (torch.zeros((64, 64), dtype=torch.int8), torch.zeros((64, 64), dtype=torch.bfloat16), 1, "both"),
    (torch.zeros((64, 64), dtype=torch.float32), torch.zeros((64, 64), dtype=torch.float32), 1, "both"),
    (torch.zeros((64, 64), dtype=torch.int8), torch.zeros((64, 32), dtype=torch.int8), 1, r"\[N, K\]"),
    (torch.zeros((64, 64), dtype=torch.int8), torch.zeros((64, 64), dtype=torch.int8), 0, "reps"),
    (torch.zeros((64, 64), dtype=torch.int8), torch.zeros((64, 64), dtype=torch.int8), 1, "CUDA"),
], ids=["m", "k", "mixed", "f32", "k-mismatch", "reps", "cpu"])
def test_mm_kernel_rejects_on_cpu(a, bt, reps, match):
    with pytest.raises(ValueError, match=match):
        int8_mm_probe.mm_kernel(a, bt, reps)


@pytest.mark.parametrize("reps", [1, 1024])
def test_mmf_kernel_order_within_tolerance(reps):
    """The kernel's order of the bf16 sums, emulated in f32 on the CPU: per
    K slice of 9 k-steps, each rep's integer-valued dot (exact) added to the
    slice's total with one round to nearest, then the slices' totals in
    order. Exact at reps 1; within reps * 2^-24 * max|y| of the plain
    version's whole dots added in order at 1024 reps, the bound [16] and the
    card tests hold the kernel to."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(_s8(rng, (64, 1152)).astype(np.float32))
    b = torch.from_numpy(_s8(rng, (1152, 64)).astype(np.float32))
    plan = int8_mm_probe.geometry(64, 64, 2 * 1152, s8=False)
    steps = 2 * 1152 // int8_mm_probe.STEP_BYTES
    edges = [s * steps // plan["slices"] * 16 for s in range(plan["slices"] + 1)]
    got = torch.zeros(64, 64)
    for lo, hi in zip(edges, edges[1:]):
        dot = a[:, lo:hi].double() @ b[lo:hi].double()
        assert torch.equal(dot, dot.float().double())  # each slice's dot is exact in f32
        total = torch.zeros(64, 64)
        for _ in range(reps):
            total += dot.float()
        got += total
    want = int8_mm_probe.mmf_plain(a.to(torch.bfloat16), b.to(torch.bfloat16), reps)
    err = float((got - want).abs().max())
    if reps == 1:
        assert err == 0.0
    else:
        assert 0.0 < err <= reps * 2.0 ** -24 * float(want.abs().max())


# caps.cu's tiling (boxes, column chunks, the ring's stages, the grid) and the
# plain versions the kernels are held against, at the kernels' other shapes.

_CAPS_PLANS = [  # name, shape, the plan's expected fields
    ("t1", (256, 128), dict(chunk=64, chunks=1, box_rows=32, units=8)),
    ("t2", (256, 128), dict(chunk=64, chunks=1, box_rows=32, units=8)),
    ("t4", (8, 64, 128), dict(rows=8, width=64, box_rows=1, units=8)),
    ("t1", (1048576, 128), dict(box_rows=64, units=16384)),
    ("t2", (1048576, 128), dict(box_rows=128, units=8192)),
    ("t4", (4096, 256, 128), dict(rows=8192, width=128, box_rows=1, units=8192)),
    ("t2", (300, 128), dict(box_rows=38, units=8)),
    ("t1", (37, 128), dict(box_rows=5, units=8)),
    ("t1", (1001, 96), dict(chunk=48, box_rows=85, units=12)),
    ("t1", (300, 1088), dict(chunk=32, chunks=17, box_rows=38, units=136)),
    ("t2", (40, 1024), dict(chunk=256, chunks=2, box_rows=5, units=16)),
    ("t2", (5000, 128), dict(box_rows=128, units=40)),
    ("t4", (2, 600, 64), dict(rows=6, width=200, chunk=32, box_rows=1, units=6)),
    ("t4", (7, 33, 1088), dict(width=33, chunk=32, chunks=17, box_rows=1, units=119)),
    ("t4", (5, 257, 64), dict(rows=1285, width=1, box_rows=161, units=8)),
]


@pytest.mark.parametrize("name,shape,want", _CAPS_PLANS,
                         ids=[f"{n}-{'x'.join(map(str, s))}" for n, s, _ in _CAPS_PLANS])
def test_caps_geometry(name, shape, want):
    plan = mosaic_caps.geometry(name, shape)
    assert {k: plan[k] for k in want} == want
    h = shape[-1] // 2
    assert plan["chunk"] % 16 == 0 and plan["chunk"] <= 256 and plan["chunk"] * plan["chunks"] == h
    assert plan["box_rows"] * plan["width"] <= 256  # one box dimension of t4's 2D store
    assert plan["box_rows"] * plan["width"] * plan["chunk"] <= max(
        mosaic_caps.HALF_BOX_BYTES[name], plan["width"] * plan["chunk"])
    assert plan["rows"] * plan["width"] == int(np.prod(shape[:-1]))
    assert plan["units"] == -(-plan["rows"] // plan["box_rows"]) * plan["chunks"]


@pytest.mark.parametrize("name,shape,match", [
    ("t1", (4, 48), "multiple of 32"),
    ("t2", (4, 0), "multiple of 32"),
    ("t1", (0, 128), "nothing to move"),
    ("t4", (3, 0, 128), "nothing to move"),
    ("t4", (4, 64), r"\[R, W, C\]"),
    ("t1", (4, 8, 64), r"\[R, C\]"),
    ("t3", (4, 64), "no caps kernel"),
    ("t2", (2 ** 32, 64), r"2\^32"),
    ("t4", (2 ** 24, 256, 64), r"2\^32"),
], ids=["t1-c48", "t2-c0", "t1-empty", "t4-empty", "t4-rank", "t1-rank", "t3", "t2-rows",
        "t4-rows"])
def test_caps_geometry_rejects(name, shape, match):
    with pytest.raises(ValueError, match=match):
        mosaic_caps.geometry(name, shape)


@pytest.mark.parametrize("r,w,c", [(16, 256, 128), (3, 100, 96), (5, 64, 128), (2, 33, 1088)],
                         ids=["slab", "ragged-w100", "ragged-r5", "wide"])
def test_caps_plain_at_kernel_shapes(r, w, c):
    """t1, t2 (on the slab's rows) and t4 plain, bit-equal to the numpy
    expressions exp/mosaic_caps.py checks its kernels with (want1, want2,
    want4), at kernel C's block-2 slab layout of batch 1 ([16, 256, 128]:
    rows 0-15 of image 0, two 64-channel pixels a row) and at rows that fill
    no box of caps.cu's."""
    slab = _s8(np.random.default_rng(r * w + c), (r, w, c))
    x, h = slab.reshape(r * w, c), c // 2
    want1 = x[:, :h].astype(np.int32) + x[:, h:].astype(np.int32)
    want2 = np.concatenate([x[:, h:], x[:, :h]], axis=1)
    want4 = np.concatenate([slab[:, :, :h].reshape(r * w, h), slab[:, :, h:].reshape(r * w, h)],
                           axis=1)
    for fn, arg, want in ((mosaic_caps.t1_plain, x, want1), (mosaic_caps.t2_plain, x, want2),
                          (mosaic_caps.t4_plain, slab, want4)):
        got = fn(torch.from_numpy(arg)).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want4, x)  # row for row a reshape


def test_caps_wrappers_take_the_plain_version_on_the_cpu():
    x = torch.from_numpy(_s8(np.random.default_rng(9), (37, 96)))
    slab = x[:36].reshape(3, 12, 96)
    for fn, plain, arg in ((mosaic_caps.t1, mosaic_caps.t1_plain, x),
                           (mosaic_caps.t2, mosaic_caps.t2_plain, x),
                           (mosaic_caps.t4, mosaic_caps.t4_plain, slab)):
        for pdl in (True, False):
            assert torch.equal(fn(arg, pdl=pdl), plain(arg))
    assert not any(mosaic_caps.launches.values())
