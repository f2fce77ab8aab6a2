"""Tests: TIFF codec, SAFE reader (fixtures), writers, geodesy."""
import json

import numpy as np
import pytest
from PIL import Image

import fixtures
import oracle
from sarpro_tpu.errors import RasterError, SafeMissingField, UnsupportedProduct
from sarpro_tpu.io import geodesy
from sarpro_tpu.io.raster import RasterReader
from sarpro_tpu.io.safe import SafeReader
from sarpro_tpu.io.tiffio import TiffReader, TiffWriter
from sarpro_tpu.io.writers import metadata as md
from sarpro_tpu.io.writers.jpeg import write_gray_jpeg, write_rgb_jpeg
from sarpro_tpu.io.writers.worldfile import write_prj_file, write_world_file


# ---------------------------------------------------------------------------
# TIFF codec
# ---------------------------------------------------------------------------
def test_tiff_roundtrip_u16_with_geo(tmp_path, rng):
    arr = rng.integers(0, 65535, (67, 123)).astype(np.uint16)
    path = tmp_path / "t.tif"
    w = TiffWriter(path)
    w.set_geotransform([500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0])
    w.set_projection("EPSG:32633")
    w.set_metadata_item("PLATFORM", "SENTINEL-1")
    w.write([arr])
    r = TiffReader(path)
    np.testing.assert_array_equal(r.read(1), arr)
    gi = r.geo_info()
    assert gi.geotransform == [500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0]
    assert gi.epsg == 32633 and not gi.is_geographic
    assert r.gdal_metadata() == {"PLATFORM": "SENTINEL-1"}


def test_tiff_two_band(tmp_path, rng):
    b1 = rng.integers(0, 255, (40, 50)).astype(np.uint8)
    b2 = rng.integers(0, 255, (40, 50)).astype(np.uint8)
    path = tmp_path / "mb.tif"
    TiffWriter(path).write([b1, b2])
    r = TiffReader(path)
    assert r.samples == 2
    np.testing.assert_array_equal(r.read(1), b1)
    np.testing.assert_array_equal(r.read(2), b2)


@pytest.mark.parametrize("compression", ["tiff_deflate", "tiff_lzw", "packbits", None])
def test_tiff_read_foreign_compressions(tmp_path, rng, compression):
    arr = rng.integers(0, 255, (33, 44)).astype(np.uint8)
    path = tmp_path / "c.tif"
    kw = {"compression": compression} if compression else {}
    Image.fromarray(arr).save(path, **kw)
    np.testing.assert_array_equal(TiffReader(path).read(1), arr)


def test_tiff_gcp_tiepoints(tmp_path, rng):
    arr = rng.integers(0, 65535, (30, 40)).astype(np.uint16)
    path = tmp_path / "g.tif"
    w = TiffWriter(path)
    w.set_projection("EPSG:4326")
    ties = [0, 0, 0, 11.0, 46.0, 0, 39, 0, 0, 11.25, 46.0, 0,
            0, 29, 0, 11.0, 45.8, 0]
    w.set_tiepoints(ties)
    w.write([arr])
    gi = TiffReader(path).geo_info()
    assert gi.geotransform is None
    assert gi.gcps is not None and gi.gcps.shape == (3, 5)
    assert gi.gcps[1, 2] == 11.25


# ---------------------------------------------------------------------------
# SAFE reader
# ---------------------------------------------------------------------------
def test_safe_reader_dual_pol(tmp_path):
    base = fixtures.make_safe(tmp_path)
    reader = SafeReader.open_with_options(base, "multiband")
    assert reader.product_type == "GRD"
    assert reader.has_vv() and reader.has_vh()
    m = reader.metadata
    assert m.platform in ("SENTINEL-1", "S1A")
    assert m.product_type == "GRD"
    assert m.orbit_number == 59968
    assert m.prf == pytest.approx(1717.128973878037)
    assert m.radar_frequency == pytest.approx(5405000454.33435)
    assert m.slant_range_near == pytest.approx(
        0.005331704801236436 * 299792458.0 / 2.0
    )
    assert m.velocity == pytest.approx(np.sqrt(1100**2 + 2100**2 + 6900**2))
    assert m.pixel_spacing_range == 10.0
    assert m.pass_direction == "ASCENDING"
    assert m.data_take_id == "487183"
    assert np.asarray(reader.vv_data()).shape == (96, 128)
    assert np.asarray(reader.vv_data()).dtype == np.float32


def test_safe_reader_single_pol_hint(tmp_path):
    base = fixtures.make_safe(tmp_path)
    reader = SafeReader.open_with_options(base, "vv")
    assert reader.has_vv() and not reader.has_vh()
    assert reader.metadata.polarizations == ["VV"]


def test_safe_reader_non_grd_rejection(tmp_path):
    base = fixtures.make_safe(tmp_path, name="slc.SAFE", product_type="SLC")
    with pytest.raises(UnsupportedProduct):
        SafeReader.open_with_options(base, "vv")
    # warnings mode skips instead
    assert SafeReader.open_with_warnings_with_options(base, "vv") is None


def test_safe_reader_missing_pol(tmp_path):
    base = fixtures.make_safe(tmp_path, name="hhonly.SAFE", pols=("hh",))
    with pytest.raises(SafeMissingField):
        SafeReader.open_with_options(base, "vv")
    assert SafeReader.open_with_warnings_with_options(base, "vv") is None
    reader = SafeReader.open_with_options(base, "hh")
    assert reader.has_hh()


def test_safe_reader_hh_hv(tmp_path):
    base = fixtures.make_safe(tmp_path, name="hhhv.SAFE", pols=("hh", "hv"))
    reader = SafeReader.open_with_options(base, "all_pairs")
    assert reader.has_hh() and reader.has_hv() and not reader.has_vv()
    assert reader.get_available_polarizations() == "HH, HV"
    ratio = np.asarray(reader.ratio_hh_hv_data())
    assert ratio.shape == (96, 128)


def test_safe_downsample_on_read(tmp_path):
    base = fixtures.make_safe(tmp_path, name="small.SAFE", shape=(96, 128))
    reader = SafeReader.open_with_options(base, "vv", None, None, 64)
    arr = np.asarray(reader.vv_data())
    assert arr.shape == (48, 64)
    assert reader.metadata.lines == 48 and reader.metadata.samples == 64


def test_safe_warped_intermediate_skipped(tmp_path, rng):
    base = fixtures.make_safe(tmp_path, name="w.SAFE", pols=("vv",))
    # drop a stale _warped intermediate next to the real measurement
    stale = base / "measurement" / "s1a-iw-grd-vv-001_warped.tiff"
    TiffWriter(stale).write([rng.integers(0, 9, (8, 8)).astype(np.uint16)])
    reader = SafeReader.open_with_options(base, "vv")
    assert np.asarray(reader.vv_data()).shape == (96, 128)


def test_auto_crs_resolution(tmp_path):
    base = fixtures.make_safe(tmp_path, name="auto.SAFE")
    # fixture GCPs center near lon 11.125, lat 45.875 -> UTM 32N
    assert geodesy.resolve_auto_target_crs(base) == "EPSG:32632"


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------
def test_world_file_pixel_center(tmp_path):
    out = tmp_path / "x.jpg"
    write_world_file(out, [500000.0, 10.0, 0.0, 4650000.0, 0.0, -10.0])
    lines = (tmp_path / "x.jgw").read_text().splitlines()
    vals = [float(v) for v in lines]
    assert vals == [10.0, 0.0, 0.0, -10.0, 500005.0, 4649995.0]
    write_prj_file(out, "EPSG:32633")
    assert (tmp_path / "x.prj").read_text() == "EPSG:32633"


def test_world_file_extensions(tmp_path):
    gt = [0.0, 1.0, 0.0, 0.0, 0.0, -1.0]
    for name, ext in [("a.jpeg", "jgw"), ("b.png", "pgw"), ("c.tiff", "tfw"),
                      ("d.xyz", "xw")]:
        write_world_file(tmp_path / name, gt)
        assert (tmp_path / name).with_suffix("." + ext).exists()


def test_jpeg_writers(tmp_path, rng):
    g = rng.integers(0, 255, (32, 48)).astype(np.uint8)
    write_gray_jpeg(tmp_path / "g.jpg", 48, 32, g)
    im = Image.open(tmp_path / "g.jpg")
    assert im.size == (48, 32) and im.mode == "L"
    rgb = rng.integers(0, 255, (32, 48, 3)).astype(np.uint8)
    write_rgb_jpeg(tmp_path / "c.jpg", 48, 32, rgb)
    im = Image.open(tmp_path / "c.jpg")
    assert im.size == (48, 32) and im.mode == "RGB"
    # quality 100 => nearly lossless
    dec = np.asarray(im).astype(int)
    assert np.abs(dec - rgb.astype(int)).mean() < 6


def test_metadata_fields_and_sidecar(tmp_path):
    base = fixtures.make_safe(tmp_path)
    reader = SafeReader.open_with_options(base, "multiband")
    meta = reader.metadata
    fields = md.extract_metadata_fields(meta, "sum")
    assert fields["POLARIZATIONS"] == "SUM(VV, VH)"
    assert fields["PRODUCT_TYPE"] == "GRD"
    assert fields["CONVERSION_TOOL"] == "SARPRO"
    fields = md.extract_metadata_fields(meta, "multiband_vv_vh")
    assert fields["POLARIZATIONS"] == "MULTIBAND(VV, VH)"

    out = tmp_path / "img.jpg"
    md.create_jpeg_metadata_sidecar_with_overrides_and_extras(
        out, meta, "multiband_vv_vh",
        [1.0, 2.0, 0.0, 3.0, 0.0, -2.0], "EPSG:32632",
        [("synthetic_rgb_mode", "Default")],
    )
    side = json.loads((tmp_path / "img.json").read_text())
    assert side["polarizations"] == "MULTIBAND(VV, VH)"
    assert side["geotransform"] == [1.0, 2.0, 0.0, 3.0, 0.0, -2.0]
    assert side["crs"] == "EPSG:32632"
    assert side["synthetic_rgb_mode"] == "Default"
    assert side["orbit_number"] == 59968  # numeric coercion


def test_tiff_metadata_embed_identity_guard(tmp_path, rng):
    """Identity geotransform -> no georeferencing, no projection
    (reference: metadata.rs:305-330)."""
    from sarpro_tpu.io.writers.tiff import write_tiff_u8

    base = fixtures.make_safe(tmp_path)
    reader = SafeReader.open_with_options(base, "vv")
    meta = reader.metadata
    meta.geotransform = [0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
    meta.projection = "EPSG:4326"
    arr = rng.integers(0, 255, (10, 12)).astype(np.uint8)
    out = tmp_path / "e.tif"
    ds = write_tiff_u8(out, 12, 10, arr)
    md.embed_tiff_metadata(ds, meta, None, None, None)
    ds.flush()
    gi = TiffReader(out).geo_info()
    assert gi.geotransform is None and gi.epsg is None


# ---------------------------------------------------------------------------
# Geodesy
# ---------------------------------------------------------------------------
def test_utm_roundtrip():
    lon = np.array([5.0, 9.0, 11.5])
    lat = np.array([44.0, 48.0, 52.5])
    e, n = geodesy.utm_forward(lon, lat, 32, False)
    lon2, lat2 = geodesy.utm_inverse(e, n, 32, False)
    np.testing.assert_allclose(lon2, lon, atol=1e-9)
    np.testing.assert_allclose(lat2, lat, atol=1e-9)


def test_lonlat_to_epsg_exceptions():
    assert geodesy.lonlat_to_epsg(9.0, 48.0) == "EPSG:32632"
    assert geodesy.lonlat_to_epsg(-70.0, -33.0) == "EPSG:32719"
    assert geodesy.lonlat_to_epsg(5.0, 60.0) == "EPSG:32632"   # Norway
    assert geodesy.lonlat_to_epsg(10.0, 78.0) == "EPSG:32633"  # Svalbard
    assert geodesy.lonlat_to_epsg(25.0, 75.0) == "EPSG:32635"  # Svalbard band
    assert geodesy.lonlat_to_epsg(0.0, 85.0) == "EPSG:32661"   # UPS N
    assert geodesy.lonlat_to_epsg(0.0, -85.0) == "EPSG:32761"  # UPS S
    assert geodesy.lonlat_to_epsg(185.0, 10.0) == geodesy.lonlat_to_epsg(-175.0, 10.0)


def test_raster_reader_identity_fallback(tmp_path, rng):
    arr = rng.integers(0, 255, (8, 9)).astype(np.uint8)
    p = tmp_path / "plain.tif"
    TiffWriter(p).write([arr])
    r = RasterReader(p)
    assert r.metadata.geotransform == [0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
    assert r.metadata.projection == ""


def test_bigtiff_roundtrip(tmp_path, rng):
    """BigTIFF layout (64-bit offsets) writes and reads back identically."""
    arr = rng.integers(0, 65535, (50, 70)).astype(np.uint16)
    path = tmp_path / "big.tif"
    w = TiffWriter(path)
    w.set_geotransform([1.0, 2.0, 0.0, 3.0, 0.0, -2.0])
    w.set_projection("EPSG:4326")
    w.set_metadata_item("K", "V")
    w.write([arr], force_bigtiff=True)
    r = TiffReader(path)
    assert r.big
    np.testing.assert_array_equal(r.read(1), arr)
    assert r.geo_info().geotransform == [1.0, 2.0, 0.0, 3.0, 0.0, -2.0]
    assert r.gdal_metadata() == {"K": "V"}


# -- foreign TIFF layout coverage: tiled / planar / predictor ----------------

def _build_tiff(path, data, *, tiled=False, tile=(16, 16), planar=1,
                predictor=1, rows_per_strip=8, compress=True):
    """Hand-rolled little-endian classic TIFF writer, independent of
    sarpro_tpu's codec, to fabricate foreign layouts our writer never emits:
    tiled, planar-configuration 2, predictor 2/3, deflate-compressed."""
    import struct as st
    import zlib as zl

    if data.ndim == 2:
        data = data[:, :, None]
    h, w, s = data.shape
    item = data.dtype.itemsize
    fmt = 3 if data.dtype.kind == "f" else 1

    def enc_predictor(block):  # block: (rows, cols, samps)
        if predictor == 2:
            out = block.astype(block.dtype).copy()
            out[:, 1:, :] = block[:, 1:, :] - block[:, :-1, :]
            return out.tobytes()
        if predictor == 3:
            r, c, ss = block.shape
            be = np.ascontiguousarray(block.astype(block.dtype.newbyteorder(">")))
            byts = be.view(np.uint8).reshape(r, c * ss, item)
            planes = byts.transpose(0, 2, 1).reshape(r, c * ss * item)
            d = planes.copy()
            d[:, 1:] = planes[:, 1:] - planes[:, :-1]
            return d.tobytes()
        return block.tobytes()

    blocks = []
    if tiled:
        tw, th = tile
        planes = range(s) if planar == 2 else [None]
        for p in planes:
            for ty in range(-(-h // th)):
                for tx in range(-(-w // tw)):
                    pad = np.zeros((th, tw, 1 if planar == 2 else s), data.dtype)
                    src = data[ty*th:ty*th+th, tx*tw:tx*tw+tw]
                    src = src[:, :, p:p+1] if planar == 2 else src
                    pad[:src.shape[0], :src.shape[1]] = src
                    blocks.append(enc_predictor(pad))
    else:
        planes = range(s) if planar == 2 else [None]
        for p in planes:
            for y0 in range(0, h, rows_per_strip):
                src = data[y0:y0+rows_per_strip]
                src = src[:, :, p:p+1] if planar == 2 else src
                blocks.append(enc_predictor(src))
    if compress:
        blocks = [zl.compress(b) for b in blocks]

    out = bytearray(st.pack("<2sHI", b"II", 42, 0))
    offsets, counts = [], []
    for b in blocks:
        offsets.append(len(out)); counts.append(len(b)); out += b
        if len(out) % 2: out += b"\0"

    def ext_array(vals, typ):  # LONG=4 SHORT=3
        sz, code = (4, "I") if typ == 4 else (2, "H")
        if len(vals) * sz <= 4:
            raw = st.pack(f"<{len(vals)}{code}", *vals).ljust(4, b"\0")
            return None, raw
        off = len(out)
        out.extend(st.pack(f"<{len(vals)}{code}", *vals))
        if len(out) % 2: out.append(0)
        return off, None

    entries = []
    def tag(t, typ, vals):
        vals = vals if isinstance(vals, (list, tuple)) else [vals]
        off, raw = ext_array(list(vals), typ)
        if raw is None:
            entries.append(st.pack("<HHII", t, typ, len(vals), off))
        else:
            entries.append(st.pack("<HHI4s", t, typ, len(vals), raw))

    tag(256, 4, w); tag(257, 4, h); tag(258, 3, [item*8]*s)
    tag(259, 3, 8 if compress else 1); tag(262, 3, 1); tag(277, 3, s)
    if tiled:
        tag(322, 4, tile[0]); tag(323, 4, tile[1])
        tag(324, 4, offsets); tag(325, 4, counts)
    else:
        tag(278, 4, rows_per_strip); tag(273, 4, offsets); tag(279, 4, counts)
    tag(284, 3, planar); tag(317, 3, predictor); tag(339, 3, [fmt]*s)

    entries.sort(key=lambda e: st.unpack("<H", e[:2])[0])
    ifd_off = len(out)
    out += st.pack("<H", len(entries)) + b"".join(entries) + st.pack("<I", 0)
    out[4:8] = st.pack("<I", ifd_off)
    import pathlib as _pl
    _pl.Path(path).write_bytes(bytes(out))


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_tiff_layout_matrix(tmp_path, rng, tiled, planar, predictor, dtype):
    """Deflate + predictor across striped/tiled × chunky/planar layouts,
    including non-multiple tile/strip edges (closes tiffio.py predictor gaps)."""
    nbands = 2 if planar == 2 else 1
    shape = (37, 53, nbands) if nbands > 1 else (37, 53)
    arr = rng.integers(0, np.iinfo(dtype).max, shape).astype(dtype)
    path = tmp_path / "x.tif"
    _build_tiff(path, arr, tiled=tiled, planar=planar, predictor=predictor)
    r = TiffReader(path)
    got = r.read(1)
    want = arr[..., 0] if nbands > 1 else arr
    np.testing.assert_array_equal(got, want)
    if nbands > 1:
        np.testing.assert_array_equal(r.read(2), arr[..., 1])


@pytest.mark.parametrize("tiled", [False, True])
def test_tiff_float_predictor3(tmp_path, rng, tiled):
    arr = rng.normal(0, 100, (29, 41)).astype(np.float32)
    path = tmp_path / "f.tif"
    _build_tiff(path, arr, tiled=tiled, predictor=3)
    np.testing.assert_array_equal(TiffReader(path).read(1), arr)


def test_tiff_lzw_predictor2_via_pil(tmp_path, rng):
    """Cross-check against an independent encoder (PIL libtiff LZW+pred2)."""
    arr = rng.integers(0, 255, (64, 96)).astype(np.uint8)
    path = tmp_path / "p.tif"
    Image.fromarray(arr).save(path, compression="tiff_lzw", tiffinfo={317: 2})
    np.testing.assert_array_equal(TiffReader(path).read(1), arr)


def test_tiff_malformed_files_raise_cleanly(tmp_path, rng):
    """Fuzz pass: truncations and corruptions must raise, not crash/hang."""
    arr = rng.integers(0, 65535, (37, 53)).astype(np.uint16)
    good = tmp_path / "good.tif"
    _build_tiff(good, arr, tiled=True, predictor=2)
    blob = good.read_bytes()
    local = np.random.default_rng(0)
    for i in range(40):
        bad = bytearray(blob)
        mode = i % 4
        if mode == 0:
            bad = bad[: local.integers(4, len(bad))]           # truncate
        elif mode == 1:
            bad[local.integers(0, len(bad))] ^= 0xFF           # bitflip
        elif mode == 2:
            pos = local.integers(4, 8)
            bad[pos] = local.integers(0, 256)                  # IFD ptr fuzz
        else:
            for _ in range(16):                                # header-area spray
                bad[local.integers(0, min(256, len(bad)))] = local.integers(0, 256)
        p = tmp_path / f"bad{i}.tif"
        p.write_bytes(bytes(bad))
        try:
            TiffReader(p).read(1)
        except Exception:
            pass  # any exception is fine; crashes/hangs are not


# -- Mercator family ----------------------------------------------------------

def test_webmercator_known_values_and_roundtrip():
    # exact edge: lon 180° → π·a
    x, y = geodesy.webmercator_forward(180.0, 0.0)
    assert x == pytest.approx(20037508.342789244, abs=1e-6)
    assert y == pytest.approx(0.0, abs=1e-9)
    lon = np.array([-150.0, -11.3, 0.0, 11.25, 77.7])
    lat = np.array([-80.0, -45.0, 0.0, 46.0, 84.9])
    x, y = geodesy.webmercator_forward(lon, lat)
    lon2, lat2 = geodesy.webmercator_inverse(x, y)
    np.testing.assert_allclose(lon2, lon, atol=1e-9)
    np.testing.assert_allclose(lat2, lat, atol=1e-9)


def test_world_mercator_roundtrip_and_ellipsoidal():
    lon = np.array([-150.0, -11.3, 0.0, 11.25, 77.7])
    lat = np.array([-80.0, -45.0, 0.0, 46.0, 84.0])
    x, y = geodesy.mercator_forward(lon, lat)
    lon2, lat2 = geodesy.mercator_inverse(x, y)
    np.testing.assert_allclose(lon2, lon, atol=1e-9)
    np.testing.assert_allclose(lat2, lat, atol=1e-9)
    # same easting as spherical, DIFFERENT northing (ellipsoidal correction)
    xs, ys = geodesy.webmercator_forward(lon, lat)
    np.testing.assert_allclose(x, xs, atol=1e-6)
    assert np.all(np.abs(y[lat != 0] - ys[lat != 0]) > 1000.0)
    # independent formulation: y = a·ln(tan(π/4+φ/2)·((1−e·sinφ)/(1+e·sinφ))^(e/2))
    phi = np.radians(46.0)
    e = np.sqrt(0.00669437999014)
    expect = 6378137.0 * np.log(
        np.tan(np.pi / 4 + phi / 2)
        * ((1 - e * np.sin(phi)) / (1 + e * np.sin(phi))) ** (e / 2)
    )
    assert geodesy.mercator_forward(0.0, 46.0)[1] == pytest.approx(expect, abs=1e-6)
    # the well-known ≤0.54% Web-vs-true-Mercator northing discrepancy
    assert 0.0050 < (ys[3] - y[3]) / ys[3] < 0.0055


def test_project_dispatch_mercators():
    for code in (3857, 3395):
        x, y = geodesy.project_forward(11.25, 46.0, code)
        lon, lat = geodesy.project_inverse(x, y, code)
        assert lon == pytest.approx(11.25, abs=1e-9)
        assert lat == pytest.approx(46.0, abs=1e-9)
        wkt = geodesy.epsg_to_wkt(code)
        assert f'"{code}"' in wkt and "Mercator" in wkt
    # the round-3 national-grid family absorbed 2154/29902/5514/27572 and
    # the cs2cs pipe backend absorbed every remaining PROJ-known method;
    # only a code PROJ itself does not know still rejects
    with pytest.raises(ValueError, match="supported:"):
        geodesy.project_forward(0.0, 0.0, 999999)


# -- streamed decimated reads --------------------------------------------------

@pytest.mark.parametrize("compression", [None, "tiff_lzw"])
def test_streamed_average_read_matches_device(tmp_path, rng, compression):
    """Native single-pass box reduce == device 'average' resample (both are
    driven by the same _build_coeffs windows)."""
    from sarpro_tpu.core.resize import resample_plane
    from sarpro_tpu import _native
    if not _native.available():
        pytest.skip("native codec not built")
    arr = rng.integers(0, 65535, (977, 1203)).astype(np.uint16)
    path = tmp_path / "s.tif"
    kw = {"compression": compression} if compression else {}
    Image.fromarray(arr).save(path, **kw)
    r = RasterReader(path)
    out_rows, out_cols = 97, 119  # ~10x reduction, fractional boxes
    got = r.read_band_resampled(1, out_cols, out_rows, "average")
    assert got.dtype == np.float32 and got.shape == (out_rows, out_cols)
    want = np.asarray(resample_plane(arr.astype(np.float32), out_rows,
                                     out_cols, "average"))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=0.05)


def test_streamed_average_chunked_equals_mmap(tmp_path, rng):
    """The chunked (compressed-file) route and the mmap route agree exactly."""
    from sarpro_tpu import _native
    if not _native.available():
        pytest.skip("native codec not built")
    arr = rng.integers(0, 65535, (500, 640)).astype(np.uint16)
    p_raw = tmp_path / "raw.tif"
    p_lzw = tmp_path / "lzw.tif"
    Image.fromarray(arr).save(p_raw)
    Image.fromarray(arr).save(p_lzw, compression="tiff_lzw")
    a = RasterReader(p_raw).read_band_resampled(1, 64, 50, "average")
    b = RasterReader(p_lzw).read_band_resampled(1, 64, 50, "average")
    np.testing.assert_array_equal(a, b)


def test_read_strip_range_decodes_only_covering_strips(tmp_path, rng):
    arr = rng.integers(0, 65535, (300, 128)).astype(np.uint16)
    path = tmp_path / "r.tif"
    Image.fromarray(arr).save(path, compression="tiff_adobe_deflate")
    t = TiffReader(path)
    assert not t._contiguous_uncompressed()
    got = t.read_strip_range(37, 251)
    np.testing.assert_array_equal(got, arr[37:251])


# ---------------------------------------------------------------------------
# Non-TIFF raster formats (PIL backend; reference opens any GDAL raster,
# gdal.rs:57-104)
# ---------------------------------------------------------------------------
def test_raster_reader_png_with_worldfile(tmp_path, rng):
    from PIL import Image

    from sarpro_tpu.io.raster import RasterReader

    a = rng.integers(0, 255, (40, 60), dtype=np.uint8)
    p = tmp_path / "r.png"
    Image.fromarray(a, "L").save(p)
    # GDAL-style sidecars: world file (pixel-center) + .prj
    gt = [500000.0, 10.0, 0.0, 5100000.0, 0.0, -10.0]
    write_world_file(p, gt)
    write_prj_file(p, "EPSG:32632")

    r = RasterReader(p)
    assert (r.metadata.size_x, r.metadata.size_y, r.metadata.bands) == (60, 40, 1)
    assert r.metadata.epsg == 32632
    assert r.metadata.geotransform == pytest.approx(gt)
    np.testing.assert_array_equal(r.read_band(1), a.astype(np.float32))
    # decimated read goes through the device resampler
    small = r.read_band_resampled(1, 30, 20, "average")
    assert small.shape == (20, 30)
    r.close()


def test_raster_reader_png_u16(tmp_path, rng):
    from PIL import Image

    from sarpro_tpu.io.raster import RasterReader

    a = rng.integers(0, 60000, (16, 24)).astype(np.uint16)
    p = tmp_path / "d.png"
    Image.fromarray(a).save(p)  # uint16 -> 16-bit PNG
    r = RasterReader(p)
    assert r.metadata.bands == 1
    np.testing.assert_array_equal(r.read_band(1), a.astype(np.float32))
    # no georeferencing sidecars: identity fallback like gdal.rs:64-67
    assert r.metadata.geotransform == [0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
    assert r.metadata.epsg is None
    r.close()


def test_raster_reader_rgb_jpeg_bands(tmp_path, rng):
    from PIL import Image

    from sarpro_tpu.io.raster import RasterReader

    rgb = rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)
    p = tmp_path / "c.bmp"  # BMP: lossless, exact band readback
    Image.fromarray(rgb, "RGB").save(p)
    r = RasterReader(p)
    assert r.metadata.bands == 3
    np.testing.assert_array_equal(r.read_band(2), rgb[:, :, 1].astype(np.float32))
    with pytest.raises(RasterError):
        r.read_band(4)
    r.close()


def test_raster_reader_unsupported_extension(tmp_path):
    from sarpro_tpu.io.raster import RasterReader

    p = tmp_path / "x.xyz"
    p.write_bytes(b"not a raster")
    with pytest.raises(RasterError, match="unsupported raster format"):
        RasterReader(p)


# ---------------------------------------------------------------------------
# Polar-science + equal-area CRS family (round 2)
# ---------------------------------------------------------------------------
def test_ups_north_epsg_worked_example():
    """EPSG guidance 7-2, Polar Stereographic variant A worked example:
    UPS North at (44E, 73N) -> E 3320416.75, N 632668.43."""
    x, y = geodesy.ups_forward(44.0, 73.0, True)
    assert float(x) == pytest.approx(3320416.75, abs=0.01)
    assert float(y) == pytest.approx(632668.43, abs=0.01)


def test_polar_stereo_variant_b_epsg_worked_example():
    """EPSG guidance 7-2, variant B worked example (Australian Antarctic
    parameters): (120E, 75S) -> E 7255380.79, N 7053389.56."""
    x, y = geodesy.polar_stereo_forward(120.0, -75.0, -71.0, 70.0,
                                        6000000.0, 6000000.0, False)
    assert float(x) == pytest.approx(7255380.79, abs=0.01)
    assert float(y) == pytest.approx(7053389.56, abs=0.01)


def test_laea_epsg_worked_example():
    """EPSG guidance 7-2, LAEA (method 9820) worked example for
    ETRS89-LAEA Europe: (5E, 50N) -> E 3962799.45, N 2999718.85."""
    x, y = geodesy.project_forward(5.0, 50.0, 3035)
    assert float(x) == pytest.approx(3962799.45, abs=0.01)
    assert float(y) == pytest.approx(2999718.85, abs=0.01)
    # grid origin maps to the false offsets exactly
    x0, y0 = geodesy.project_forward(10.0, 52.0, 3035)
    assert float(x0) == pytest.approx(4321000.0, abs=1e-6)
    assert float(y0) == pytest.approx(3210000.0, abs=1e-6)


def test_south_polar_easting_orientation():
    """Regression for the round-1 south-aspect mirror: east longitudes must
    map to eastings RIGHT of the pole for south aspects too (EPSG 9810/9829:
    E = FE + rho*sin(lam-lam0) for both aspects)."""
    for code in (32761, 3031, 3976):
        x, _ = geodesy.project_forward(90.0, -75.0, code)  # due east of lam0=0
        info = geodesy.epsg_kind(code)
        fe = 2000000.0 if info["kind"] == "ups" else info["fe"]
        assert float(x) > fe, f"EPSG:{code} easting mirrored"


@pytest.mark.parametrize("code,lat_range", [
    (3413, (60, 89)), (3976, (-89, -55)), (3031, (-89, -60)),
    (3035, (35, 70)),
])
def test_new_crs_roundtrip(code, lat_range):
    rng = np.random.default_rng(5)
    lons = rng.uniform(-170, 170, 60)
    lats = rng.uniform(*lat_range, 60)
    x, y = geodesy.project_forward(lons, lats, code)
    lo2, la2 = geodesy.project_inverse(x, y, code)
    np.testing.assert_allclose(lo2, lons, atol=1e-7)
    np.testing.assert_allclose(la2, lats, atol=1e-7)
    wkt = geodesy.epsg_to_wkt(code)
    assert wkt and f'AUTHORITY["EPSG","{code}"]' in wkt


def test_world_file_gdal_extension_convention(tmp_path, rng):
    """Code-review regression: GDAL's world-file convention is first+last
    letter + 'w' (bmp->bpw); the reader must find those sidecars."""
    from PIL import Image as _Image

    from sarpro_tpu.io.pilraster import world_file_candidates
    from sarpro_tpu.io.raster import RasterReader

    from pathlib import Path as _P
    names = [c.suffix for c in world_file_candidates(_P("r.bmp"))]
    assert ".bpw" in names and ".wld" in names and ".bmpw" in names
    a = rng.integers(0, 255, (10, 12), dtype=np.uint8)
    p = tmp_path / "r.bmp"
    _Image.fromarray(a, "L").save(p)
    gt = [100.0, 2.0, 0.0, 50.0, 0.0, -2.0]
    # GDAL-style .bpw sidecar (pixel-center)
    (tmp_path / "r.bpw").write_text(
        "2.0\n0.0\n0.0\n-2.0\n101.0\n49.0\n")
    r = RasterReader(p)
    assert r.metadata.geotransform == pytest.approx(gt)


def test_raster_reader_content_probe_odd_extension(tmp_path, rng):
    """Code-review regression: a TIFF named scene.img must open through the
    native codec by magic, like GDAL's open-by-content (gdal.rs:57-104)."""
    from sarpro_tpu.io.raster import RasterReader

    a = rng.integers(0, 60000, (20, 30)).astype(np.uint16)
    p = tmp_path / "scene.img"
    w = TiffWriter(p)
    w.set_geotransform([0.0, 5.0, 0.0, 100.0, 0.0, -5.0])
    w.set_projection("EPSG:32632")
    w.write([a])
    r = RasterReader(p)
    assert r.metadata.epsg == 32632
    np.testing.assert_array_equal(r.read_band(1), a.astype(np.float32))


def test_rgb_jpeg_bgr_order_identical(tmp_path, rng):
    """channel_order='bgr' must produce the same encoded image as the RGB
    path fed the equivalent RGB array (the fused program emits BGR for the
    cv2 writer at zero device cost)."""
    rgb = rng.integers(0, 255, (32, 48, 3)).astype(np.uint8)
    write_rgb_jpeg(tmp_path / "rgb.jpg", 48, 32, rgb)
    write_rgb_jpeg(tmp_path / "bgr.jpg", 48, 32, rgb[..., ::-1],
                   channel_order="bgr")
    a = (tmp_path / "rgb.jpg").read_bytes()
    b = (tmp_path / "bgr.jpg").read_bytes()
    assert a == b


def test_jp2_raster_reads_lossless_u16(tmp_path, rng):
    """JPEG2000 through the PIL/openjpeg backend (format breadth of the
    reference's GdalSarReader::open, gdal.rs:57-104): reversible u16 single
    band and 8-bit RGB both decode exactly."""
    import warnings

    from sarpro_tpu.io.raster import RasterReader

    a = rng.integers(0, 60000, (64, 80)).astype(np.uint16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        Image.fromarray(a, mode="I;16").save(tmp_path / "u16.jp2")
    r = RasterReader(tmp_path / "u16.jp2")
    assert (r.metadata.size_x, r.metadata.size_y) == (80, 64)
    np.testing.assert_array_equal(r.read_band(1), a.astype(np.float32))

    rgb = rng.integers(0, 255, (32, 40, 3)).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "rgb.jp2")
    r2 = RasterReader(tmp_path / "rgb.jp2")
    assert r2.metadata.bands == 3
    np.testing.assert_array_equal(r2.read_band(2), rgb[..., 1].astype(np.float32))


def test_jp2_world_file_georeferencing(tmp_path, rng):
    """JP2 + .j2w world file yields a geotransform like GDAL's worldfile
    probing."""
    from sarpro_tpu.io.raster import RasterReader

    a = rng.integers(0, 255, (16, 20)).astype(np.uint8)
    Image.fromarray(a, mode="L").save(tmp_path / "g.jp2")
    # pixel-center world file: 10m pixels at (500000, 4000000)
    (tmp_path / "g.j2w").write_text(
        "10.0\n0.0\n0.0\n-10.0\n500005.0\n3999995.0\n")
    r = RasterReader(tmp_path / "g.jp2")
    gt = r.metadata.geotransform
    assert gt[0] == pytest.approx(500000.0) and gt[3] == pytest.approx(4000000.0)
    assert gt[1] == 10.0 and gt[5] == -10.0


def _write_nc(path, var_name, data, y=None, x=None, var_attrs=None,
              extra_vars=None, global_attrs=None, dims=("y", "x")):
    """CF-style classic netCDF writer for the reader tests (scipy backend)."""
    from scipy.io import netcdf_file

    with netcdf_file(str(path), "w") as nc:
        for k, v in (global_attrs or {}).items():
            setattr(nc, k, v)
        lead = data.shape[:-2]
        all_dims = tuple(f"d{i}" for i in range(len(lead))) + tuple(dims)
        for d, n in zip(all_dims, data.shape):
            nc.createDimension(d, n)
        if y is not None:
            vy = nc.createVariable(dims[0], y.dtype, (dims[0],))
            vy[:] = y
            vy.units = "m" if dims[0] == "y" else "degrees_north"
        if x is not None:
            vx = nc.createVariable(dims[1], x.dtype, (dims[1],))
            vx[:] = x
            vx.units = "m" if dims[1] == "x" else "degrees_east"
        v = nc.createVariable(var_name, data.dtype, all_dims)
        v[:] = data
        for k, val in (var_attrs or {}).items():
            setattr(v, k, val)
        for name, (vdata, vdims, vattrs) in (extra_vars or {}).items():
            # scipy's scalar-variable writer breaks on modern numpy; give
            # grid-mapping variables a 1-length dimension instead
            if not vdims:
                nc.createDimension(f"{name}_scalar", 1)
                vdims = (f"{name}_scalar",)
                vdata = np.asarray(vdata).reshape(1)
            ev = nc.createVariable(name, vdata.dtype, vdims)
            ev[:] = vdata
            for k, val in vattrs.items():
                setattr(ev, k, val)


def test_netcdf_raster_reads_values_and_geotransform(tmp_path, rng):
    """netCDF classic grid (format breadth of GdalSarReader::open,
    gdal.rs:57-104): values read exactly, pixel-center coordinate axes
    become a GDAL edge-anchored geotransform."""
    from sarpro_tpu.io.raster import RasterReader

    a = rng.integers(0, 60000, (24, 30)).astype(np.int32)
    # 10m pixels, y descending from 4000000 (north-up), x from 500000
    y = (4000000.0 - 5.0 - 10.0 * np.arange(24)).astype(np.float64)
    x = (500000.0 + 5.0 + 10.0 * np.arange(30)).astype(np.float64)
    _write_nc(tmp_path / "g.nc", "sigma0", a, y=y, x=x,
              global_attrs={"title": "test grid"})
    r = RasterReader(tmp_path / "g.nc")
    assert (r.metadata.size_x, r.metadata.size_y) == (30, 24)
    assert r.metadata.bands == 1
    gt = r.metadata.geotransform
    assert gt[0] == pytest.approx(500000.0) and gt[3] == pytest.approx(4000000.0)
    assert gt[1] == pytest.approx(10.0) and gt[5] == pytest.approx(-10.0)
    np.testing.assert_array_equal(r.read_band(1), a.astype(np.float32))
    assert r.metadata.metadata.get("NC_GLOBAL#title") == "test grid"


def test_netcdf_raster_grid_mapping_epsg_and_bands(tmp_path, rng):
    """grid_mapping spatial_ref WKT resolves the EPSG code; a 3D variable
    exposes one band per leading slice."""
    from sarpro_tpu.io.raster import RasterReader

    a = rng.random((3, 8, 10)).astype(np.float32)
    wkt = ('PROJCS["WGS 84 / UTM zone 32N",GEOGCS["WGS 84",DATUM["WGS_1984",'
           'SPHEROID["WGS 84",6378137,298.257223563]],PRIMEM["Greenwich",0],'
           'UNIT["degree",0.0174532925199433]],PROJECTION['
           '"Transverse_Mercator"],AUTHORITY["EPSG","32632"]]')
    _write_nc(tmp_path / "m.nc", "backscatter", a,
              var_attrs={"grid_mapping": "crs"},
              extra_vars={"crs": (np.int32(0), (), {"spatial_ref": wkt})})
    r = RasterReader(tmp_path / "m.nc")
    assert r.metadata.bands == 3
    assert r.metadata.epsg == 32632
    np.testing.assert_allclose(r.read_band(3), a[2], rtol=1e-6)


def test_netcdf_raster_lonlat_degrees_is_4326(tmp_path, rng):
    """degree-unit lon/lat coordinate axes imply EPSG:4326 like GDAL's
    netCDF driver."""
    from sarpro_tpu.io.raster import RasterReader

    a = rng.integers(0, 255, (6, 9)).astype(np.int16)
    lat = (50.0 - 0.25 * np.arange(6)).astype(np.float64)
    lon = (10.0 + 0.25 * np.arange(9)).astype(np.float64)
    _write_nc(tmp_path / "ll.nc", "dn", a, y=lat, x=lon, dims=("lat", "lon"))
    r = RasterReader(tmp_path / "ll.nc")
    assert r.metadata.epsg == 4326


def test_netcdf_hdf5_container_rejected(tmp_path):
    """netCDF-4 (HDF5) magic gets a clear RasterError, not a parse crash."""
    from sarpro_tpu.errors import RasterError
    from sarpro_tpu.io.raster import RasterReader

    p = tmp_path / "v4.nc"
    p.write_bytes(b"\x89HDF\r\n\x1a\n" + b"\x00" * 64)
    with pytest.raises(RasterError, match="netCDF-4"):
        RasterReader(p)
