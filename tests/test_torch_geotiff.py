"""The port's native GeoTIFF library (witw_tpu_torch/native/geotiff_io.cpp,
bound by witw_tpu_torch.tools.geotiff) on tests/test_geotiff.py's cases,
each run against both packages' libraries, and the two packages against
each other: each reads the other's files identically and
``write_geotiff_u8`` writes the same bytes. A failed build raises with
the compiler's output; nothing falls back.
"""

import ctypes
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from witw_tpu.tools import geotiff as jgt
from witw_tpu_torch.tools import geotiff as tgt

GTF = np.array([447000.0, 0.3, 0, 5411000.0, 0, -0.3])


@pytest.fixture(scope="module", params=["witw_tpu", "port"])
def gt(request):
    mod = jgt if request.param == "witw_tpu" else tgt
    if mod.native_lib() is None:
        pytest.fail("witw_tpu's native geotiff_io library did not build")
    return mod


@pytest.fixture
def lib(gt):
    return gt.native_lib()


def test_write_read_roundtrip(tmp_path, gt, rng):
    data = rng.integers(0, 255, size=(37, 53, 3), dtype=np.uint8)
    path = str(tmp_path / "rt.tif")
    gt.write_geotiff_u8(path, data, geotransform=GTF, epsg=32631)
    with gt.GeoTiff(path) as tif:
        assert (tif.height, tif.width, tif.bands) == (37, 53, 3)
        assert tif.epsg == 32631
        np.testing.assert_allclose(tif.geotransform, GTF)
        np.testing.assert_array_equal(tif.read(), data)
        win = tif.read_window(-5, 10, 20, 20)  # out-of-bounds zero fill
        np.testing.assert_array_equal(win[:, :5], 0)
        np.testing.assert_array_equal(win[:, 5:], data[10:30, 0:15])


@pytest.mark.parametrize("kw", [{}, {"compression": "tiff_adobe_deflate"},
                                {"compression": "tiff_lzw"}], ids=["raw", "deflate", "lzw"])
def test_reads_pil_written_tiffs(tmp_path, gt, rng, kw):
    data = rng.integers(0, 255, size=(40, 30, 3), dtype=np.uint8)
    path = str(tmp_path / "pil.tif")
    Image.fromarray(data).save(path, **kw)
    with gt.GeoTiff(path) as tif:
        np.testing.assert_array_equal(tif.read(), data)


def test_read_uint16(tmp_path, gt, rng):
    data = rng.integers(0, 65535, size=(25, 31), dtype=np.uint16)
    path = str(tmp_path / "u16.tif")
    Image.fromarray(data).save(path)
    with gt.GeoTiff(path) as tif:
        assert tif.dtype == np.uint16
        np.testing.assert_array_equal(tif.read()[..., 0], data)


def test_pil_reads_our_tiffs(tmp_path, gt, rng):
    data = rng.integers(0, 255, size=(33, 44, 3), dtype=np.uint8)
    path = str(tmp_path / "ours.tif")
    gt.write_geotiff_u8(path, data, compress=True)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), data)


def test_resample_constant_preserved(gt):
    src = np.full((16, 16, 2), 7.0, np.float32)
    for method in ("bilinear", "lanczos"):
        out = gt.resample(src, 9, 23, method)
        assert out.shape == (9, 23, 2)
        np.testing.assert_allclose(out, 7.0, rtol=1e-5)


def test_resample_downscale_average(gt):
    src = ((np.indices((8, 8)).sum(0) % 2) * 200.0).astype(np.float32)[..., None]
    out = gt.resample(src, 4, 4, "bilinear")
    np.testing.assert_allclose(out[1:-1, 1:-1], 100.0, atol=1e-4)
    np.testing.assert_allclose(out, 100.0, atol=7.0)


def test_world_window_read(tmp_path, gt, rng):
    data = rng.integers(0, 255, size=(100, 100, 3), dtype=np.uint8)
    path = str(tmp_path / "w.tif")
    gt.write_geotiff_u8(path, data, geotransform=np.array([1000.0, 0.5, 0, 2000.0, 0, -0.5]),
                        epsg=32631)
    with gt.GeoTiff(path) as tif:
        # 10 m x 10 m starting 5 m into the raster = pixels [10:30, 10:30]
        np.testing.assert_array_equal(tif.read_world_window(1005.0, 1995.0, 1015.0, 1985.0),
                                      data[10:30, 10:30])
        out = tif.read_world_window(1005.0, 1995.0, 1015.0, 1985.0, out_size=(8, 8))
        assert out.shape == (8, 8, 3) and out.dtype == np.uint8


# --- adversarial and corrupt files: the parser fails cleanly, never crashes ---


def _find_tag(buf: bytes, code: int, ttype: int, count: int) -> int:
    return buf.find(struct.pack("<HHI", code, ttype, count))


def _malicious_lzw_stream(n_codes: int) -> bytes:
    """Literal-0 codes with no clear code: an unbounded table overruns 4096."""
    bits, next_code, first = 9, 258, True
    acc, nbits, out = 0, 0, bytearray()
    for _ in range(n_codes):
        acc = acc << bits
        nbits += bits
        while nbits >= 8:
            out.append((acc >> (nbits - 8)) & 0xFF)
            nbits -= 8
        if first:
            first = False
        else:
            next_code += 1
            if next_code == (1 << bits) - 1 and bits < 12:
                bits += 1
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


def _open_and_read(lib, path):
    """Drive the C ABI directly; returns (opened, read rc)."""
    h = lib.gt_open(str(path).encode())
    if not h:
        return False, None
    handle = ctypes.c_void_p(h)
    w = min(max(int(lib.gt_width(handle)), 1), 64)
    hgt = min(max(int(lib.gt_height(handle)), 1), 64)
    buf = np.zeros((hgt, w, max(int(lib.gt_bands(handle)), 1)), np.uint16)
    rc = lib.gt_read_window(handle, 0, 0, w, hgt,
                            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    lib.gt_close(handle)
    return True, rc


def _as_lzw(gt, path, data, stream):
    gt.write_geotiff_u8(str(path), data, compress=False)
    raw = bytearray(path.read_bytes())
    comp_at, off_at, cnt_at = (_find_tag(raw, c, t, 1) for c, t in ((259, 3), (273, 4), (279, 4)))
    assert comp_at >= 0 and off_at >= 0 and cnt_at >= 0
    struct.pack_into("<I", raw, comp_at + 8, 5)  # compression = LZW
    strip_off = struct.unpack_from("<I", raw, off_at + 8)[0]
    struct.pack_into("<I", raw, cnt_at + 8, len(stream))
    path.write_bytes(bytes(raw[:strip_off] + stream))


def test_lzw_table_overrun_rejected(tmp_path, gt, lib, rng):
    path = tmp_path / "evil_lzw.tif"
    _as_lzw(gt, path, rng.integers(0, 255, size=(64, 64, 1), dtype=np.uint8),
            _malicious_lzw_stream(4200))
    opened, rc = _open_and_read(lib, path)
    assert opened and rc != 0


def test_undefined_lzw_code_rejected(tmp_path, gt, lib, rng):
    acc = 400 << 7  # a first 9-bit code of 400 > next_code 258
    path = tmp_path / "evil_code.tif"
    _as_lzw(gt, path, rng.integers(0, 255, size=(8, 8, 1), dtype=np.uint8),
            bytes([acc >> 8 & 0xFF, acc & 0xFF]))
    opened, rc = _open_and_read(lib, path)
    assert opened and rc != 0


def test_absurd_dimensions_rejected(tmp_path, gt, lib, rng):
    path = tmp_path / "evil_dims.tif"
    gt.write_geotiff_u8(str(path), rng.integers(0, 255, size=(8, 8, 3), dtype=np.uint8),
                        compress=False)
    raw = bytearray(path.read_bytes())
    w_at, h_at = _find_tag(raw, 256, 4, 1), _find_tag(raw, 257, 4, 1)
    assert w_at >= 0 and h_at >= 0
    struct.pack_into("<I", raw, w_at + 8, 0xFFFFFFF0)
    struct.pack_into("<I", raw, h_at + 8, 0xFFFFFFF0)
    path.write_bytes(bytes(raw))
    opened, rc = _open_and_read(lib, path)
    assert (not opened) or rc != 0


def test_absurd_tag_count_rejected(tmp_path, gt, lib, rng):
    path = tmp_path / "evil_count.tif"
    gt.write_geotiff_u8(str(path), rng.integers(0, 255, size=(8, 8, 3), dtype=np.uint8),
                        compress=False)
    raw = bytearray(path.read_bytes())
    bps_at = _find_tag(raw, 258, 3, 3)  # BitsPerSample claims 2^32 - 1 values
    assert bps_at >= 0
    struct.pack_into("<I", raw, bps_at + 4, 0xFFFFFFFF)
    path.write_bytes(bytes(raw))
    opened, rc = _open_and_read(lib, path)
    assert opened in (True, False)


def test_truncated_file_rejected(tmp_path, gt, lib, rng):
    path = tmp_path / "trunc.tif"
    gt.write_geotiff_u8(str(path), rng.integers(0, 255, size=(32, 32, 3), dtype=np.uint8),
                        compress=True)
    raw = path.read_bytes()
    path.write_bytes(raw[: len(raw) // 2])
    opened, rc = _open_and_read(lib, path)
    assert (not opened) or rc != 0


def test_fuzz_mutated_tiffs_never_crash(tmp_path, gt, lib, rng):
    base = {}
    for name, compress in (("plain", False), ("deflate", True)):
        p = tmp_path / f"{name}.tif"
        gt.write_geotiff_u8(str(p), rng.integers(0, 255, (24, 40, 3), dtype=np.uint8),
                            geotransform=np.array([0.0, 1, 0, 0, 0, -1]), epsg=32601,
                            compress=compress)
        base[name] = bytearray(p.read_bytes())
    mut = np.random.default_rng(99)
    evil = tmp_path / "fuzz.tif"
    for trial in range(300):
        raw = bytearray(base["plain" if trial % 2 else "deflate"])
        op = trial % 3
        if op == 0:  # flips in the header / IFD region
            for _ in range(int(mut.integers(1, 8))):
                raw[int(mut.integers(0, min(len(raw), 256)))] = int(mut.integers(0, 256))
        elif op == 1:  # flips anywhere
            for _ in range(int(mut.integers(1, 16))):
                raw[int(mut.integers(0, len(raw)))] = int(mut.integers(0, 256))
        else:
            raw = raw[: int(mut.integers(8, len(raw)))]
        evil.write_bytes(bytes(raw))
        opened, rc = _open_and_read(lib, evil)
        assert opened in (True, False)


def test_big_endian_predictor16_decodes_exactly(tmp_path, lib, rng):
    """A big-endian 16-bit deflate stream with the horizontal predictor:
    the byte swap comes before the predictor's sums."""
    h, w = 4, 6
    arr = rng.integers(0, 65535, (h, w)).astype(np.uint16)
    arr[0, 0], arr[0, 1] = 0x00FF, 0x0100  # a low-byte carry (diff 1)
    diff = arr.astype(np.int64).copy()
    diff[:, 1:] = (arr[:, 1:].astype(np.int64) - arr[:, :-1].astype(np.int64)) % 65536
    payload = zlib.compress(diff.astype(">u2").tobytes())
    n_tags = 10
    data_off = 8 + 2 + n_tags * 12 + 4

    def tag(code, ttype, count, value):
        head = struct.pack(">HHI", code, ttype, count)
        return head + (struct.pack(">HH", value, 0) if ttype == 3 else struct.pack(">I", value))

    buf = struct.pack(">2sHI", b"MM", 42, 8) + struct.pack(">H", n_tags)
    for code, ttype, value in ((256, 4, w), (257, 4, h), (258, 3, 16), (259, 3, 8), (262, 3, 1),
                               (273, 4, data_off), (277, 3, 1), (278, 4, h),
                               (279, 4, len(payload)), (317, 3, 2)):
        buf += tag(code, ttype, 1, value)
    buf += struct.pack(">I", 0) + payload
    path = tmp_path / "be_pred16.tif"
    path.write_bytes(buf)
    handle = ctypes.c_void_p(lib.gt_open(str(path).encode()))
    assert handle
    out = np.zeros((h, w, 1), np.uint16)
    rc = lib.gt_read_window(handle, 0, 0, w, h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    lib.gt_close(handle)
    assert rc == 0
    np.testing.assert_array_equal(out[..., 0], arr)


# --- the two packages against each other ---


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "deflate"])
def test_packages_write_the_same_bytes_and_read_each_other(tmp_path, rng, compress):
    data = rng.integers(0, 255, size=(61, 47, 3), dtype=np.uint8)
    paths = {}
    for name, mod in (("witw_tpu", jgt), ("port", tgt)):
        paths[name] = str(tmp_path / f"{name}.tif")
        mod.write_geotiff_u8(paths[name], data, geotransform=GTF, epsg=32631, compress=compress)
    with open(paths["witw_tpu"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    for writer, path in paths.items():
        with jgt.GeoTiff(path) as want, tgt.GeoTiff(path) as got:
            np.testing.assert_array_equal(got.read(), want.read(), err_msg=writer)
            np.testing.assert_array_equal(got.read_window(-3, 40, 30, 30),
                                          want.read_window(-3, 40, 30, 30))
            np.testing.assert_array_equal(got.geotransform, want.geotransform)
            assert (got.epsg, got.dtype) == (want.epsg, want.dtype)
            np.testing.assert_array_equal(
                got.read_world_window(447003.0, 5410997.0, 447009.0, 5410991.0, out_size=(7, 9)),
                want.read_world_window(447003.0, 5410997.0, 447009.0, 5410991.0, out_size=(7, 9)))
    src = rng.uniform(0, 255, (50, 70, 3)).astype(np.float32)
    for method in ("bilinear", "lanczos"):
        np.testing.assert_array_equal(tgt.resample(src, 33, 21, method),
                                      jgt.resample(src, 33, 21, method))


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int f() { return undeclared_name; }\n')
    with pytest.raises(RuntimeError, match="undeclared_name"):
        tgt.build_native(bad, tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))


def test_unreadable_files_raise(tmp_path):
    """Where witw_tpu falls back to imageio, the port raises."""
    path = tmp_path / "not_a_tiff.tif"
    path.write_bytes(b"nope")
    with pytest.raises(IOError, match="cannot open"):
        tgt.GeoTiff(str(path))
    with pytest.raises(ValueError, match="resample method"):
        tgt.resample(np.zeros((4, 4, 1), np.float32), 2, 2, "nearest")
