"""National-grid CRS family: LCC 1SP/2SP, Albers, generic TM + datum shifts.

gdalwarp accepts any PROJ-known `-t_srs`
(reference: src/io/sentinel1.rs:988-1003); these tests pin our
self-contained projection math for the most common national grids against
the system PROJ (`cs2cs`) as oracle, check WKT emission round-trips, and
drive the full warp path to the new families.
"""
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

import fixtures
from sarpro_tpu.io import geodesy
from sarpro_tpu.io import warp as warp_mod
from sarpro_tpu.io.raster import RasterReader
from sarpro_tpu.io.safe import SafeReader
from sarpro_tpu.io.tiffio import TiffWriter
from sarpro_tpu.io.writers.worldfile import write_prj_file

HAS_CS2CS = shutil.which("cs2cs") is not None
HAS_PROJINFO = shutil.which("projinfo") is not None

# CRSs whose OFFICIAL axis order is (northing, easting): cs2cs prints N,E
# and projinfo cannot match our (traditional GIS, GDAL-style) E,N WKT at
# 100%. The framework, like GDAL, always works in E,N.
AXIS_NORTH_EAST = {2193, 31466, 31467, 31468}

# (code, in-domain probe lat/lon box: lat_lo, lat_hi, lon_lo, lon_hi)
GRIDS = {
    2154: (42.5, 50.5, -4.0, 7.5),     # RGF93 / Lambert-93 (LCC 2SP)
    3347: (45.0, 70.0, -130.0, -60.0),  # NAD83 / StatCan Lambert (LCC 2SP)
    24200: (17.7, 18.5, -78.4, -76.2),  # JAD69 / Jamaica (LCC 1SP + datum)
    5070: (25.0, 48.0, -122.0, -70.0),  # NAD83 / CONUS Albers
    3577: (-43.0, -11.0, 114.0, 153.0),  # GDA94 / Australian Albers
    27700: (50.0, 60.5, -7.5, 1.7),    # OSGB36 / BNG (TM + Helmert datum)
    3067: (59.8, 70.0, 19.5, 31.5),    # ETRS89 / TM35FIN
    25832: (36.0, 70.0, 6.0, 12.0),    # ETRS89 / UTM 32N
    2193: (-47.0, -34.5, 167.0, 178.5),  # NZGD2000 / NZTM
    3978: (43.0, 75.0, -135.0, -55.0),   # NAD83 / Canada Atlas Lambert
    3310: (32.5, 42.0, -124.0, -114.0),  # NAD83 / California Albers
    25833: (36.0, 70.0, 12.0, 18.0),
    25835: (36.0, 70.0, 24.0, 30.0),
    29902: (51.4, 55.4, -10.5, -5.4),   # TM65 / Irish Grid (mod Airy + Helmert)
    2157: (51.4, 55.4, -10.5, -5.4),    # IRENET95 / Irish TM
    2056: (45.8, 47.8, 6.0, 10.5),      # CH1903+ / LV95 (Swiss somerc + datum)
    21781: (45.8, 47.8, 6.0, 10.5),     # CH1903 / LV03 (legacy Swiss)
    # Czechia-only box (north of Slovakia's EPSG extent) so cs2cs
    # deterministically picks "S-JTSK to WGS 84 (5)", the op we implement
    5514: (49.7, 51.0, 12.2, 18.5),     # S-JTSK / Krovak East North
    27572: (44.0, 49.5, -2.0, 7.0),     # NTF (Paris) / Lambert zone II
    # Germany box inside the BETA2007 NTv2 grid: the datum leg runs
    # through the distortion grid, exactly as cs2cs does
    31466: (47.5, 54.5, 6.5, 9.0),      # DHDN / Gauss-Kruger zone 2
    31467: (47.5, 54.5, 7.0, 11.0),     # DHDN / Gauss-Kruger zone 3
    31468: (47.5, 54.5, 10.5, 14.5),    # DHDN / Gauss-Kruger zone 4
}


def _cs2cs(pts_latlon, code):
    """Oracle: WGS84 lat/lon → EPSG:code easting/northing via system PROJ."""
    inp = "\n".join(f"{lat:.10f} {lon:.10f}" for lat, lon in pts_latlon)
    r = subprocess.run(
        ["cs2cs", "EPSG:4326", f"EPSG:{code}", "-f", "%.6f"],
        input=inp + "\n", capture_output=True, text=True, check=True,
    )
    out = []
    for line in r.stdout.strip().splitlines():
        x, y = line.split()[:2]
        out.append((float(x), float(y)))
    return np.array(out)


@pytest.mark.skipif(not HAS_CS2CS, reason="cs2cs (PROJ) not available")
@pytest.mark.parametrize("code", sorted(GRIDS))
def test_forward_matches_proj_oracle(code):
    """project_forward must agree with cs2cs to centimeters over a domain
    grid (includes the OSGB36/JAD69 Helmert datum legs — PROJ's grid-free
    default transformations, the same ones gdalwarp falls back to)."""
    lat_lo, lat_hi, lon_lo, lon_hi = GRIDS[code]
    lats = np.linspace(lat_lo, lat_hi, 7)
    lons = np.linspace(lon_lo, lon_hi, 7)
    pts = [(la, lo) for la in lats for lo in lons]
    oracle = _cs2cs(pts, code)
    if code in AXIS_NORTH_EAST:
        oracle = oracle[:, ::-1]
    lat_arr = np.array([p[0] for p in pts])
    lon_arr = np.array([p[1] for p in pts])
    x, y = geodesy.project_forward(lon_arr, lat_arr, code)
    err = np.hypot(x - oracle[:, 0], y - oracle[:, 1])
    assert err.max() < 0.02, f"EPSG:{code} worst {err.max():.4f} m vs cs2cs"


@pytest.mark.parametrize("code", sorted(GRIDS))
def test_inverse_roundtrip_subcentimeter(code):
    lat_lo, lat_hi, lon_lo, lon_hi = GRIDS[code]
    lats = np.linspace(lat_lo, lat_hi, 9)
    lons = np.linspace(lon_lo, lon_hi, 9)
    lo, la = np.meshgrid(lons, lats)
    x, y = geodesy.project_forward(lo.ravel(), la.ravel(), code)
    lon2, lat2 = geodesy.project_inverse(x, y, code)
    # ~1 cm in degrees
    assert np.hypot(lon2 - lo.ravel(), lat2 - la.ravel()).max() * 111000 < 0.01


@pytest.mark.parametrize("code", sorted(GRIDS))
def test_wkt_emission_roundtrip(code, tmp_path):
    wkt = geodesy.epsg_to_wkt(code)
    assert wkt is not None
    assert geodesy.parse_epsg_code(wkt) == code
    # .prj sidecar round-trip (reference: writers/worldfile.rs:57-64)
    out = tmp_path / f"g{code}.jpg"
    out.write_bytes(b"")
    write_prj_file(out, wkt)
    assert (tmp_path / f"g{code}.prj").read_text() == wkt


@pytest.mark.skipif(not HAS_PROJINFO, reason="projinfo (PROJ) not available")
@pytest.mark.parametrize("code", sorted(GRIDS))
def test_wkt_identified_by_proj(code):
    """The emitted WKT1 must be recognized by PROJ as exactly this CRS —
    the 'opens correctly in GIS tooling' criterion."""
    wkt = geodesy.epsg_to_wkt(code)
    r = subprocess.run(["projinfo", "--identify", wkt],
                       capture_output=True, text=True)
    want = "25 %" if code in AXIS_NORTH_EAST else "100 %"
    hits = [ln for ln in r.stdout.splitlines()
            if f"EPSG:{code}" in ln and want in ln]
    assert hits, f"projinfo did not identify EPSG:{code} ({want})"


# ---------------------------------------------------------------------------
# Full warp-path integration on the new families
# ---------------------------------------------------------------------------
def _gcp_raster(tmp_path, code, lon0, lat0, span=0.25, rows=96, cols=128):
    rng = np.random.default_rng(5)
    dn = rng.integers(1, 60000, (rows, cols)).astype(np.uint16)
    path = tmp_path / f"src{code}.tiff"
    w = TiffWriter(path)
    n = 5
    ties = []
    for iy in range(n):
        for ix in range(n):
            ties.extend([
                ix * (cols - 1) / (n - 1), iy * (rows - 1) / (n - 1), 0.0,
                lon0 + span * ix / (n - 1), lat0 - span * iy / (n - 1), 0.0,
            ])
    w.set_projection("EPSG:4326")
    w.set_tiepoints(ties)
    w.write([dn])
    return RasterReader(path)


@pytest.mark.parametrize("code,lon0,lat0", [
    (2154, 2.2, 48.9),      # Paris
    (5070, -98.0, 39.0),    # Kansas
    (27700, -1.5, 52.5),    # Midlands
    (3067, 25.0, 62.0),     # Finland
    (24200, -77.2, 18.2),   # Jamaica
    (3577, 147.0, -36.0),   # Australia
    (29902, -7.5, 53.3),    # Ireland
    (2056, 8.2, 46.8),      # Switzerland (oblique Mercator)
    (5514, 14.4, 50.0),     # Czechia (Krovak)
    (27572, 2.3, 46.8),     # France legacy (Paris meridian Lambert)
    (31467, 9.5, 50.5),     # Germany (NTv2 grid-shift datum)
])
def test_warp_mapping_to_national_grid(tmp_path, code, lon0, lat0):
    """plan_warp to each new family: the coarse inverse-mapping grid the
    device sampler consumes stays within 0.1 px of the exact f64 mapping
    (GDAL's approximate-transformer tolerance is 0.125 px)."""
    reader = _gcp_raster(tmp_path, code, lon0, lat0)
    plan = warp_mod.plan_warp(reader, f"EPSG:{code}", target_size=None)
    ys = np.linspace(0.0, plan.out_rows - 1.0, 61)
    xs = np.linspace(0.0, plan.out_cols - 1.0, 61)
    xx, yy = np.meshgrid(xs, ys)
    ex, ey = plan.exact_source_pixels(xx.ravel(), yy.ravel())
    ix, iy = plan.interp_source_pixels(xx.ravel(), yy.ravel())
    assert np.hypot(ix - ex, iy - ey).max() < 0.1
    # output grid pixel size ~ source ground sampling (suggested resolution)
    gt = plan.geotransform
    assert gt[1] > 0 and -gt[5] > 0
    reader.close()


@pytest.mark.skipif(not HAS_CS2CS, reason="cs2cs (PROJ) not available")
def test_warp_grid_pixel_error_vs_proj_oracle(tmp_path):
    """End-to-end mapping error vs PROJ for EPSG:2154: compose the oracle's
    inverse projection with the plan's TPS; the plan's source-pixel mapping
    must agree within 0.1 px."""
    code, lon0, lat0 = 2154, 2.2, 48.9
    reader = _gcp_raster(tmp_path, code, lon0, lat0)
    plan = warp_mod.plan_warp(reader, f"EPSG:{code}", target_size=None)
    gt = plan.geotransform
    ys = np.linspace(0.0, plan.out_rows - 1.0, 13)
    xs = np.linspace(0.0, plan.out_cols - 1.0, 13)
    xx, yy = np.meshgrid(xs, ys)
    tx = gt[0] + (xx.ravel() + 0.5) * gt[1]
    ty = gt[3] + (yy.ravel() + 0.5) * gt[5]
    # oracle inverse: EPSG:2154 -> WGS84 via cs2cs
    inp = "\n".join(f"{x:.6f} {y:.6f}" for x, y in zip(tx, ty))
    r = subprocess.run(["cs2cs", f"EPSG:{code}", "EPSG:4326", "-f", "%.10f"],
                       input=inp + "\n", capture_output=True, text=True,
                       check=True)
    ll = np.array([[float(v) for v in ln.split()[:2]]
                   for ln in r.stdout.strip().splitlines()])
    lat, lon = ll[:, 0], ll[:, 1]  # EPSG:4326 axis order is lat,lon
    # fixture lattice is an exact affine lon/lat -> pixel mapping; the plan
    # returns source sampling coordinates (GCP pixel index - 0.5, the
    # pixel-as-area convention of the device sampler)
    rows, cols = 96, 128
    px_oracle = (lon - lon0) / 0.25 * (cols - 1) - 0.5
    py_oracle = (lat0 - lat) / 0.25 * (rows - 1) - 0.5
    ex, ey = plan.exact_source_pixels(xx.ravel(), yy.ravel())
    err = np.hypot(ex - px_oracle, ey - py_oracle)
    assert err.max() < 0.1, f"worst mapping error {err.max():.4f} px vs PROJ"
    reader.close()


def test_safe_open_warps_to_lambert93(tmp_path):
    """SafeReader full warp path with a national-grid target: metadata gains
    the Lambert-93 geotransform/projection and the raster is resampled."""
    base = fixtures.make_safe(tmp_path, name="l93.SAFE", pols=("vv",))
    reader = SafeReader.open_with_options(
        base, "vv", "EPSG:2154", "bilinear", 64)
    arr = np.asarray(reader.vv_data())
    assert max(arr.shape) == 64
    assert geodesy.parse_epsg_code(reader.metadata.projection) == 2154
    gt = reader.metadata.geotransform
    # fixture scene sits near lon 11E lat 46N; Lambert-93 coordinates there
    x, y = geodesy.project_forward(11.125, 45.875, 2154)
    assert abs(gt[0] - x) < 100000 and abs(gt[3] - y) < 100000


# ---------------------------------------------------------------------------
# NTv2 grid-shift reader
# ---------------------------------------------------------------------------
HAS_BETA2007 = any(
    (pathlib.Path(d) / "BETA2007.gsb").is_file()
    for d in ("/usr/share/proj",) if pathlib.Path(d).is_dir()
)


@pytest.mark.skipif(not HAS_BETA2007, reason="BETA2007.gsb not installed")
def test_ntv2_reader_parses_beta2007():
    from sarpro_tpu.io.ntv2 import load_grid

    g = load_grid("BETA2007.gsb")
    assert g is not None
    assert g.source.startswith("DHDN") and g.target.startswith("ETRS")
    (sub,) = g.subgrids
    # 84 x 62 nodes over Germany (47N..55.3N, 5.5E..15.67E)
    assert sub.shifts.shape == (84, 62, 2)
    dlat, dwest = g.shift(9.0, 50.0)
    # DHDN->ETRS89 over Germany is a few arc-seconds
    assert 0.1 < abs(float(dlat)) < 10 and 0.1 < abs(float(dwest)) < 10


@pytest.mark.skipif(not HAS_BETA2007, reason="BETA2007.gsb not installed")
def test_ntv2_forward_inverse_roundtrip():
    from sarpro_tpu.io.ntv2 import load_grid

    g = load_grid("BETA2007.gsb")
    lons = np.linspace(6.5, 14.5, 9)
    lats = np.linspace(47.5, 54.5, 9)
    lo, la = np.meshgrid(lons, lats)
    lon2, lat2, ok = g.apply(lo.ravel(), la.ravel(), forward=True)
    assert ok.all()
    lon3, lat3, ok2 = g.apply(lon2, lat2, forward=False)
    assert ok2.all()
    # sub-millimeter round trip through the iterative inverse
    assert np.hypot(lon3 - lo.ravel(), lat3 - la.ravel()).max() * 111000 < 1e-3


def test_ntv2_outside_grid_falls_back_to_helmert():
    """Points outside the BETA2007 extent (or hosts without the file) use
    the DHDN Helmert fallback — the shift must still produce a plausible
    (~100 m class) displacement, never NaN/passthrough."""
    from sarpro_tpu.io.geodesy import _datum_shift

    lon, lat = _datum_shift(-3.0, 40.0, "dhdn", to_wgs84=True)  # Madrid
    d_m = float(np.hypot(lon - -3.0, lat - 40.0)) * 111000
    assert np.isfinite(d_m) and 10 < d_m < 500


@pytest.mark.skipif(not HAS_BETA2007, reason="BETA2007.gsb not installed")
def test_ntv2_truncated_grid_degrades_to_none(tmp_path, monkeypatch):
    """A truncated/malformed .gsb must load as None (→ Helmert fallback),
    never crash the transform; and a miss is not cached, so a grid
    installed later is picked up."""
    from sarpro_tpu.io import ntv2

    src = pathlib.Path("/usr/share/proj/BETA2007.gsb").read_bytes()
    monkeypatch.setenv("PROJ_DATA", str(tmp_path))
    ntv2._CACHE.clear()
    for n in (100, 180, 250, 2000):
        (tmp_path / "BETA2007.gsb").write_bytes(src[:n])
        ntv2._CACHE.clear()
        assert ntv2.load_grid("BETA2007.gsb") is None, n
    # now install the real grid at the same path: picked up immediately
    (tmp_path / "BETA2007.gsb").write_bytes(src)
    ntv2._CACHE.clear()
    assert ntv2.load_grid("BETA2007.gsb") is not None
    ntv2._CACHE.clear()
