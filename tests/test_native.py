"""Tests for the native TIFF codec (ctypes) and its Python fallbacks."""
import numpy as np
import pytest
from oracle import jpeg_dct_oracle as _dct_oracle
from PIL import Image

from sarpro_tpu import _native
from sarpro_tpu.io import tiffio
from sarpro_tpu.io.tiffio import TiffReader

needs_native = pytest.mark.skipif(
    not _native.available(), reason="native codec not built"
)


@needs_native
def test_native_lzw_matches_python(rng):
    arr = rng.integers(0, 255, (200, 300)).astype(np.uint8)
    Image.fromarray(arr).save("/tmp/_t_lzw.tif", compression="tiff_lzw")
    r = TiffReader("/tmp/_t_lzw.tif")
    blob = None
    r._fh.seek(int(r.offsets[0]))
    blob = r._fh.read(int(r.byte_counts[0]))
    cap = int(r.rows_per_strip) * r.width
    native = _native.lzw_decode(blob, cap)
    python = tiffio._lzw_decode(blob)[:cap]
    assert native == python


@needs_native
def test_native_packbits_matches_python(rng):
    # runs + literals
    data = np.repeat(rng.integers(0, 255, 50).astype(np.uint8), rng.integers(1, 9, 50))
    import io

    im = Image.fromarray(data.reshape(1, -1))
    im.save("/tmp/_t_pb.tif", compression="packbits")
    r = TiffReader("/tmp/_t_pb.tif")
    r._fh.seek(int(r.offsets[0]))
    blob = r._fh.read(int(r.byte_counts[0]))
    native = _native.packbits_decode(blob, data.size)
    python = tiffio._packbits_decode(blob)[:data.size]
    assert native == python


@needs_native
def test_native_parallel_strip_read(rng):
    """Many-strip LZW file decodes identically through the parallel path."""
    arr = rng.integers(0, 255, (512, 640)).astype(np.uint8)
    Image.fromarray(arr).save("/tmp/_t_strips.tif", compression="tiff_lzw",
                              tiffinfo={278: 32})  # RowsPerStrip=32
    r = TiffReader("/tmp/_t_strips.tif")
    assert len(r.offsets) > 4
    np.testing.assert_array_equal(r.read(1), arr)


def test_python_fallback_used_when_unavailable(rng, monkeypatch):
    arr = rng.integers(0, 255, (64, 64)).astype(np.uint8)
    Image.fromarray(arr).save("/tmp/_t_fb.tif", compression="tiff_lzw")
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_TRIED", True)
    assert not _native.available()
    np.testing.assert_array_equal(TiffReader("/tmp/_t_fb.tif").read(1), arr)


def test_predictor2_undo(rng):
    """Horizontal differencing predictor (deflate path, Python)."""
    rows, cols = 40, 96
    orig = rng.integers(0, 255, (rows, cols)).astype(np.uint8)
    # build a deflate TIFF with predictor=2 by hand via the writer + patching
    import struct
    import zlib

    diff = orig.astype(np.int16).copy()
    diff[:, 1:] = (orig[:, 1:].astype(np.int16) - orig[:, :-1].astype(np.int16))
    payload = zlib.compress(diff.astype(np.uint8).tobytes())
    # minimal single-strip TIFF
    tags = []

    def tag(tid, ftype, count, value):
        tags.append(struct.pack("<HHI4s", tid, ftype, count, value))

    data_offset = 8 + 2 + 12 * 9 + 4
    tag(256, 3, 1, struct.pack("<HH", cols, 0))
    tag(257, 3, 1, struct.pack("<HH", rows, 0))
    tag(258, 3, 1, struct.pack("<HH", 8, 0))
    tag(259, 3, 1, struct.pack("<HH", 8, 0))        # deflate
    tag(262, 3, 1, struct.pack("<HH", 1, 0))
    tag(273, 4, 1, struct.pack("<I", data_offset))
    tag(279, 4, 1, struct.pack("<I", len(payload)))
    tag(278, 3, 1, struct.pack("<HH", rows, 0))
    tag(317, 3, 1, struct.pack("<HH", 2, 0))        # predictor=2
    buf = b"II" + struct.pack("<HI", 42, 8)
    buf += struct.pack("<H", len(tags)) + b"".join(tags) + struct.pack("<I", 0)
    buf += payload
    path = "/tmp/_t_pred.tif"
    with open(path, "wb") as fh:
        fh.write(buf)
    got = TiffReader(path).read(1)
    np.testing.assert_array_equal(got, orig)


@needs_native
@pytest.mark.parametrize("shape", [
    (997, 1003, 101, 97),    # ragged windows, u32 horizontal path
    (512, 512, 64, 64),      # exact 8x8 boxes
    (2654, 2654, 7, 7),      # ~379x379 boxes -> u64 horizontal (wide) path
    (40, 60, 13, 17),        # tiny, windows of 2-4
])
def test_box_reduce_matches_f64_oracle(rng, shape):
    """The SIMD box reducer must match a float64 box-average oracle to f32
    precision on both the u32 and the wide-window u64 horizontal paths
    (reference semantics: GDAL Average decimation, src/io/gdal.rs:145-177)."""
    from sarpro_tpu.io.raster import _average_windows

    H, W, oh, ow = shape
    src = rng.integers(0, 65536, (H, W)).astype(np.uint16)
    ys, yc = _average_windows(H, oh)
    xs, xc = _average_windows(W, ow)
    out = np.empty((oh, ow), np.float32)
    _native.box_reduce_u16(src, out, 0, oh, ys, yc, xs, xc)
    oracle = np.empty((oh, ow), np.float64)
    for oy in range(oh):
        colsum = src[ys[oy]:ys[oy] + yc[oy]].astype(np.float64).sum(axis=0)
        for ox in range(ow):
            s = colsum[xs[ox]:xs[ox] + xc[ox]].sum()
            oracle[oy, ox] = s / yc[oy] / xc[ox]
    err = np.abs(out.astype(np.float64) - oracle).max()
    assert err / max(oracle.max(), 1.0) < 1e-6


@needs_native
def test_box_reduce_chunked_src_row0(rng):
    """Chunked callers pass src_row0 > 0; partial output ranges must match
    the full-array reduction exactly."""
    from sarpro_tpu.io.raster import _average_windows

    H, W, oh, ow = 300, 200, 31, 23
    src = rng.integers(0, 65536, (H, W)).astype(np.uint16)
    ys, yc = _average_windows(H, oh)
    xs, xc = _average_windows(W, ow)
    full = np.empty((oh, ow), np.float32)
    _native.box_reduce_u16(src, full, 0, oh, ys, yc, xs, xc)
    o0, o1 = 10, 20
    r0, r1 = int(ys[o0]), int(ys[o1 - 1] + yc[o1 - 1])
    part = np.empty((o1 - o0, ow), np.float32)
    _native.box_reduce_u16(np.ascontiguousarray(src[r0:r1]), part, o0, o1,
                           ys, yc, xs, xc, src_row0=r0)
    np.testing.assert_array_equal(part, full[o0:o1])


@needs_native
def test_native_jpeg_encoder_decodes_everywhere(rng, tmp_path):
    """native/jpegenc.cpp (the self-contained analogue of the reference's
    jpeg-encoder crate, jpeg.rs:6-30): q100 4:4:4 streams must decode in
    both PIL and cv2 with near-lossless error, including odd sizes (edge
    replication) and flat content (EOB/ZRL paths)."""
    import io

    for (h, w) in [(8, 8), (33, 47), (64, 64)]:
        rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        R, G, B = [rgb[..., i].astype(np.float64) for i in range(3)]
        Y = np.clip(np.round(0.299 * R + 0.587 * G + 0.114 * B),
                    0, 255).astype(np.uint8)
        Cb = np.clip(np.round(-0.168735892 * R - 0.331264108 * G + 0.5 * B
                              + 128), 0, 255).astype(np.uint8)
        Cr = np.clip(np.round(0.5 * R - 0.418687589 * G - 0.081312411 * B
                              + 128), 0, 255).astype(np.uint8)
        blob = _native.jpeg_encode_ycbcr444(
            *[np.ascontiguousarray(p) for p in (Y, Cb, Cr)])
        assert blob[:2] == b"\xff\xd8" and blob[-2:] == b"\xff\xd9"
        dec = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
        err = np.abs(dec.astype(int) - rgb.astype(int))
        assert err.mean() < 2.5 and err.max() <= 30
        import cv2

        cvdec = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
        assert cvdec is not None and cvdec.shape == (h, w, 3)
    # flat content exercises long zero runs + EOB
    flat = np.full((64, 64), 128, np.uint8)
    flat[10, 20] = 200
    blob = _native.jpeg_encode_gray(flat)
    dec = np.asarray(Image.open(io.BytesIO(blob)).convert("L"))
    assert np.abs(dec.astype(int) - flat.astype(int)).max() <= 3


@needs_native
def test_write_synrgb_jpeg_ycbcr_matches_bgr_pixels(rng, tmp_path):
    """The planar-YCbCr native path and the BGR cv2 path must produce
    visually identical files from the same fused output (decoded pixel
    error within the q100 round-trip bound)."""
    import jax.numpy as jnp

    from sarpro_tpu.core import fused
    from sarpro_tpu.io.writers.jpeg import write_synrgb_jpeg
    from sarpro_tpu.types import AutoscaleStrategy

    vv = rng.integers(0, 60000, (96, 80)).astype(np.uint16)
    vh = rng.integers(0, 30000, (96, 80)).astype(np.uint16)
    kw = dict(strategy=AutoscaleStrategy.CLAHE, target_size=64, pad=True)
    ycbcr = np.asarray(fused.synrgb_pipeline(vv, vh, channel_order="ycbcr", **kw))
    assert ycbcr.shape == (3, 64, 64)
    bgr = np.asarray(fused.synrgb_pipeline(vv, vh, channel_order="bgr", **kw))
    write_synrgb_jpeg(tmp_path / "y.jpg", 64, 64, ycbcr, layout="ycbcr")
    write_synrgb_jpeg(tmp_path / "b.jpg", 64, 64, bgr, layout="bgr")
    a = np.asarray(Image.open(tmp_path / "y.jpg").convert("RGB")).astype(int)
    b = np.asarray(Image.open(tmp_path / "b.jpg").convert("RGB")).astype(int)
    assert np.abs(a - b).mean() < 1.5


@needs_native
def test_fused_ycbcr_matches_host_conversion(rng):
    """Device-side JFIF color conversion == host f64 conversion of the RGB
    output (within 1 for float-order ties)."""
    import jax.numpy as jnp

    from sarpro_tpu.core import fused
    from sarpro_tpu.types import AutoscaleStrategy

    vv = rng.integers(0, 60000, (64, 48)).astype(np.uint16)
    vh = rng.integers(0, 30000, (64, 48)).astype(np.uint16)
    kw = dict(strategy=AutoscaleStrategy.TAMED, target_size=None)
    rgb = np.asarray(fused.synrgb_pipeline(vv, vh, **kw)).astype(np.float64)
    ycbcr = np.asarray(fused.synrgb_pipeline(vv, vh, channel_order="ycbcr", **kw))
    R, G, B = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    want = np.stack([
        np.round(0.299 * R + 0.587 * G + 0.114 * B),
        np.round(-0.168735892 * R - 0.331264108 * G + 0.5 * B + 128),
        np.round(0.5 * R - 0.418687589 * G - 0.081312411 * B + 128),
    ])
    assert np.abs(ycbcr.astype(np.int64) - np.clip(want, 0, 255)).max() <= 1




@needs_native
def test_jpeg_coeffs_entry_byte_identical_on_exact_blocks(rng):
    """Constant 8x8 blocks have exactly representable DCTs (DC only), so the
    pixel path and the coefficient path must produce byte-identical streams
    — validates the entropy-only entry incl. DC prediction, EOB, and the
    multithread restart-band split."""
    h, w = 96, 104
    vals = rng.integers(0, 256, (3, h // 8, w // 8)).astype(np.uint8)
    planes = np.ascontiguousarray(
        np.repeat(np.repeat(vals, 8, axis=1), 8, axis=2))
    coeffs = _dct_oracle(planes)
    for nt in (1, 4):
        ref = _native.jpeg_encode_ycbcr444(*planes, n_threads=nt)
        got = _native.jpeg_encode_coeffs444(
            coeffs[0], coeffs[1], coeffs[2], w, h, n_threads=nt)
        assert got == ref
    gref = _native.jpeg_encode_gray(planes[0], n_threads=1)
    ggot = _native.jpeg_encode_coeffs_gray(coeffs[0], w, h, n_threads=1)
    assert ggot == gref


@needs_native
def test_jpeg_coeffs_entry_decodes_like_pixel_path(rng):
    """On arbitrary content the coefficient entry (fed the f64 DCT oracle)
    must decode within a hair of the pixel path's stream (both are q100
    round-trips of the same planes; DCTs differ only in rounding)."""
    import io

    h, w = 72, 56
    planes = np.ascontiguousarray(
        rng.integers(0, 256, (3, h, w)).astype(np.uint8))
    coeffs = _dct_oracle(planes)
    a = np.asarray(Image.open(io.BytesIO(_native.jpeg_encode_ycbcr444(
        *planes))).convert("RGB")).astype(int)
    b = np.asarray(Image.open(io.BytesIO(_native.jpeg_encode_coeffs444(
        coeffs[0], coeffs[1], coeffs[2], w, h))).convert("RGB")).astype(int)
    assert np.abs(a - b).max() <= 2


@needs_native
def test_fused_dct_planes_match_oracle(rng):
    """Device JPEG front-end (fused.jpeg_dct_planes): coefficients within ±1
    of the f64 oracle (f32 contraction rounding), edge replication on
    non-multiple-of-8 sizes identical to the host encoder's load_block."""
    from sarpro_tpu.core import fused

    planes = np.ascontiguousarray(
        rng.integers(0, 256, (3, 40, 48)).astype(np.uint8))
    got = np.asarray(fused.jpeg_dct_planes(planes))
    assert got.shape == (3, 5, 6, 8, 8) and got.dtype == np.int16
    assert np.abs(got.astype(int) - _dct_oracle(planes).astype(int)).max() <= 1
    # odd size: replicate edges like load_block (jpegenc.cpp)
    odd = planes[:, :37, :42]
    rep = np.ascontiguousarray(
        np.pad(odd, ((0, 0), (0, 3), (0, 6)), mode="edge"))
    got = np.asarray(fused.jpeg_dct_planes(odd))
    assert got.shape == (3, 5, 6, 8, 8)
    assert np.abs(got.astype(int) - _dct_oracle(rep).astype(int)).max() <= 1
    # odd BLOCK count in width: the pair-of-blocks operator computes an
    # extra pad block that must be sliced off (fused._dct_pair_split)
    oddblocks = planes[:, :, :40]
    got = np.asarray(fused.jpeg_dct_planes(oddblocks))
    assert got.shape == (3, 5, 5, 8, 8)
    assert np.abs(got.astype(int)
                  - _dct_oracle(oddblocks).astype(int)).max() <= 1


@needs_native
def test_write_synrgb_jpeg_dct_matches_ycbcr_pixels(rng, tmp_path):
    """End-to-end: the device-DCT layout must produce a file visually
    identical to the planar-YCbCr path from the same fused inputs."""
    from sarpro_tpu.core import fused
    from sarpro_tpu.io.writers.jpeg import write_synrgb_jpeg
    from sarpro_tpu.types import AutoscaleStrategy

    vv = rng.integers(0, 60000, (96, 80)).astype(np.uint16)
    vh = rng.integers(0, 30000, (96, 80)).astype(np.uint16)
    kw = dict(strategy=AutoscaleStrategy.CLAHE, target_size=64, pad=True)
    dct = np.asarray(fused.synrgb_pipeline(vv, vh, channel_order="dct", **kw))
    assert dct.shape == (3, 8, 8, 8, 8) and dct.dtype == np.int16
    ycbcr = np.asarray(fused.synrgb_pipeline(vv, vh, channel_order="ycbcr", **kw))
    write_synrgb_jpeg(tmp_path / "d.jpg", 64, 64, dct, layout="dct")
    write_synrgb_jpeg(tmp_path / "y.jpg", 64, 64, ycbcr, layout="ycbcr")
    a = np.asarray(Image.open(tmp_path / "d.jpg").convert("RGB")).astype(int)
    b = np.asarray(Image.open(tmp_path / "y.jpg").convert("RGB")).astype(int)
    assert np.abs(a - b).max() <= 2


@needs_native
def test_gray_jpeg_dct_path_matches_u8_path(rng, tmp_path):
    """grayscale_pipeline(jpeg_dct=True) + the entropy-only gray entry must
    write a file visually identical to the u8-plane native encode."""
    from sarpro_tpu.core import fused
    from sarpro_tpu.io.writers.jpeg import write_gray_jpeg, write_gray_jpeg_dct
    from sarpro_tpu.types import AutoscaleStrategy, BitDepth

    dn = rng.integers(0, 60000, (96, 80)).astype(np.uint16)
    kw = dict(strategy=AutoscaleStrategy.ROBUST, bit_depth=BitDepth.U8,
              target_size=64, pad=True)
    u8 = np.asarray(fused.grayscale_pipeline(dn, **kw))
    co = np.asarray(fused.grayscale_pipeline(dn, jpeg_dct=True, **kw))
    assert co.shape == (8, 8, 8, 8) and co.dtype == np.int16
    assert np.abs(co.astype(int)
                  - _dct_oracle(u8[None]).astype(int)[0]).max() <= 1
    write_gray_jpeg(tmp_path / "u.jpg", 64, 64, u8)
    write_gray_jpeg_dct(tmp_path / "d.jpg", 64, 64, co)
    a = np.asarray(Image.open(tmp_path / "u.jpg").convert("L")).astype(int)
    b = np.asarray(Image.open(tmp_path / "d.jpg").convert("L")).astype(int)
    assert np.abs(a - b).max() <= 2


@needs_native
def test_write_synrgb_jpeg_dct_odd_dims(rng, tmp_path):
    """Non-multiple-of-8 output dims: partial border blocks are
    edge-replicated on device; the file must carry the TRUE dimensions and
    decode like the u8-plane path."""
    from sarpro_tpu.core import fused
    from sarpro_tpu.io.writers.jpeg import write_synrgb_jpeg
    from sarpro_tpu.types import AutoscaleStrategy

    vv = rng.integers(0, 60000, (90, 70)).astype(np.uint16)
    vh = rng.integers(0, 30000, (90, 70)).astype(np.uint16)
    kw = dict(strategy=AutoscaleStrategy.TAMED, target_size=52, pad=False)
    # 90x70 -> long side 52 keeps aspect: 52 rows x ~40 cols
    from sarpro_tpu.core.fused import _plan_read_dims

    rows, cols, _ = _plan_read_dims(90, 70, 52, None)
    assert rows % 8 or cols % 8  # the point of the test
    dct = np.asarray(fused.synrgb_pipeline(vv, vh, channel_order="dct", **kw))
    ycbcr = np.asarray(fused.synrgb_pipeline(vv, vh, channel_order="ycbcr", **kw))
    write_synrgb_jpeg(tmp_path / "d.jpg", cols, rows, dct, layout="dct")
    write_synrgb_jpeg(tmp_path / "y.jpg", cols, rows, ycbcr, layout="ycbcr")
    a = Image.open(tmp_path / "d.jpg")
    assert a.size == (cols, rows)
    av = np.asarray(a.convert("RGB")).astype(int)
    bv = np.asarray(Image.open(tmp_path / "y.jpg").convert("RGB")).astype(int)
    assert np.abs(av - bv).max() <= 2


@needs_native
def test_jpeg_coeffs_out_of_range_clamps_not_corrupts():
    """AC = -1024 maps to value-table index 0 (unfilled) and |v| > 1023
    exceeds baseline AC category 10: both must CLAMP to ±1023 (valid
    stream, nearest representable value) rather than silently dropping the
    coefficient or emitting undefined Huffman symbols (review finding)."""
    import io

    u = np.arange(8, dtype=np.float64)
    s = np.where(u == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    T = s[:, None] * np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16)
    for bad in (-1024, -5000, 4000):
        co = np.zeros((1, 1, 64), np.int16)
        co[0, 0, 0] = 40        # DC
        co[0, 0, 8] = bad       # transposed flat 8 = zigzag position 1
        blob = _native.jpeg_encode_coeffs_gray(co, 8, 8)
        dec = np.asarray(
            Image.open(io.BytesIO(blob)).convert("L")).astype(np.float64)
        C = np.zeros((8, 8))
        C[0, 0] = 40
        C[1, 0] = float(np.clip(bad, -1023, 1023))
        block = T.T @ C.T @ T   # inverse of C = (T·B·Tᵀ)ᵀ
        want = np.clip(np.rint(block + 128), 0, 255)
        assert np.abs(dec - want).max() <= 2, f"coeff {bad} mishandled"


@needs_native
def test_preferred_jpeg_layouts_are_transport_aware(monkeypatch):
    """One layout rule on every backend: the fused program ends in the JPEG
    front-end ('dct') whenever the native encoder is built; without it the
    device emits pixels for cv2/Pillow."""
    import jax

    from sarpro_tpu.io.writers import jpeg as jw

    for backend in ("cpu", "gpu"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        assert jw.preferred_synrgb_layout() == "dct"
        assert jw.preferred_gray_layout() == "dct"
    monkeypatch.setattr(_native, "available", lambda: False)
    assert jw.preferred_synrgb_layout() == "bgr"
    assert jw.preferred_gray_layout() == "u8"


@needs_native
def test_jpeg_multithread_restart_intervals(rng):
    """n_threads > 1 splits MCU rows into restart-interval bands (DRI +
    RST markers) encoded in parallel; decoded pixels must be identical to
    the single-scan stream for every thread count."""
    import io

    h, w = 120, 88
    Y, Cb, Cr = [np.ascontiguousarray(
        rng.integers(0, 256, (h, w)).astype(np.uint8)) for _ in range(3)]
    ref = _native.jpeg_encode_ycbcr444(Y, Cb, Cr, n_threads=1)
    assert b"\xff\xdd" not in ref[:700]  # single scan: no DRI segment
    d_ref = np.asarray(Image.open(io.BytesIO(ref)).convert("RGB"))
    for nt in (2, 4, 8):
        blob = _native.jpeg_encode_ycbcr444(Y, Cb, Cr, n_threads=nt)
        assert b"\xff\xdd" in blob[:700]  # DRI present
        dec = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
        np.testing.assert_array_equal(dec, d_ref)
    g = np.ascontiguousarray(rng.integers(0, 256, (h, w)).astype(np.uint8))
    g1 = _native.jpeg_encode_gray(g, n_threads=1)
    g4 = _native.jpeg_encode_gray(g, n_threads=4)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(g1)).convert("L")),
        np.asarray(Image.open(io.BytesIO(g4)).convert("L")))


def _zigzag_rc():
    """zigzag k -> (row, col); input blocks are stored TRANSPOSED, so the
    coefficient for zigzag k sits at flat index col*8 + row."""
    out = [(0, 0)]
    r = c = 0
    up = True
    for _ in range(63):
        if up:
            if c == 7: r += 1; up = False
            elif r == 0: c += 1; up = False
            else: r -= 1; c += 1
        else:
            if r == 7: c += 1; up = True
            elif c == 0: r += 1; up = True
            else: r += 1; c -= 1
        out.append((r, c))
    return out


@needs_native
def test_jpeg_coeffs_grouped_append_edge_patterns():
    """Zigzag-tail and grouping edge cases for the entropy coder's
    pair/triple/quad appends and the sentinel-bounded scan
    (native/jpegenc.cpp encode_block): nonzero runs ending exactly at
    zigzag 61/62/63 (a group must never swallow the out-of-range sentinel
    at [64]), EOB-only blocks, long zero runs (ZRL), max-category values
    whose code pairs exceed one 32-bit append, and dense/alternating
    patterns. Round-tripped EXACTLY through the pure-Python baseline
    Huffman decoder (tests/oracle.py) — a pixel decode can't check these,
    because libjpeg's IDCT range limiter wraps on synthetic out-of-range
    coefficient blocks."""
    from oracle import decode_baseline_jpeg_coeffs

    zig_rc = _zigzag_rc()
    patterns = [
        {},                                  # EOB-only (all-zero AC)
        {63: 5},                             # lone last coefficient
        {61: 3, 62: -4, 63: 5},              # triple ending at the edge
        {60: 2, 61: 3, 62: -4, 63: 5},       # quad ending at the edge
        {59: 1, 60: 2, 61: 3, 62: -4, 63: 5},
        {1: 7, 50: -2},                      # ZRL x3 + coded run
        {1: -1023, 2: 1023, 3: -1023},       # 26-bit codes: pair > 32 bits
        {1: 1023, 63: -1023},
        dict((k, (-1) ** k * ((k % 7) + 1)) for k in range(1, 64)),  # dense
        dict((k, (k % 5) - 2) for k in range(1, 64, 2)),  # alternating
        {62: -1, 63: 1},                     # pair exactly at the edge
        {16: 16, 17: -16, 18: 16, 19: -16},  # mid-block quad
        {1: -1024, 40: 2000, 41: -2000},     # out-of-range -> clamp ±1023
    ]
    for dc in (0, 40, -200):
        for pat in patterns:
            co = np.zeros((1, 1, 64), np.int16)
            co[0, 0, 0] = dc
            want = [dc] + [0] * 63
            for k, v in pat.items():
                rr, cc = zig_rc[k]
                co[0, 0, cc * 8 + rr] = v
                want[k] = int(np.clip(v, -1023, 1023))
            blob = _native.jpeg_encode_coeffs_gray(co, 8, 8)
            blocks, ncomp = decode_baseline_jpeg_coeffs(blob, 1)
            assert ncomp == 1 and len(blocks) == 1
            assert blocks[0] == want, (dc, pat)


@needs_native
def test_jpeg_coeffs_roundtrip_fuzz_multiblock(rng):
    """Randomized exact round-trip through the Huffman-decoder oracle:
    3-component interleaved scan over several blocks (DC prediction chains
    across MCUs), sparse SAR-like magnitudes plus occasional large values,
    single-scan and restart-interval (n_threads > 1) streams."""
    from oracle import decode_baseline_jpeg_coeffs

    zig_rc = _zigzag_rc()
    h = w = 24  # 9 MCUs
    nb = (h // 8) * (w // 8)
    comps = []
    want_zz = [[], [], []]  # per component, per block, zigzag list
    for ci in range(3):
        co = np.zeros((nb, 64), np.int16)
        for b in range(nb):
            nnz = int(rng.integers(0, 64))
            ks = rng.choice(63, size=nnz, replace=False) + 1
            vals = rng.integers(-8, 9, size=nnz)
            big = rng.random(nnz) < 0.1
            vals = np.where(big, rng.integers(-1023, 1024, size=nnz), vals)
            zz = [int(rng.integers(-300, 300))] + [0] * 63  # DC
            for k, v in zip(ks, vals):
                if v == 0:
                    continue
                rr, cc = zig_rc[k]
                co[b, cc * 8 + rr] = v
                zz[k] = int(v)
            co[b, 0] = zz[0]
            want_zz[ci].append(zz)
        comps.append(np.ascontiguousarray(co.reshape(-1)))
    for nt in (1, 3):
        blob = _native.jpeg_encode_coeffs444(
            comps[0], comps[1], comps[2], w, h, n_threads=nt)
        blocks, ncomp = decode_baseline_jpeg_coeffs(blob, nb)
        assert ncomp == 3 and len(blocks) == nb * 3
        for b in range(nb):
            for ci in range(3):
                assert blocks[b * 3 + ci] == want_zz[ci][b], (nt, b, ci)
