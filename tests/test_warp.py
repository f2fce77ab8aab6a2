"""Warp validation hardening.

Covers: annotation geolocation-grid points as a TPS control source (the
lattice `gdalwarp -tps` reads from the raster, sourced from the annotation
XML instead when the measurement TIFF carries no GCPs), suggested-resolution
output grids against analytic mappings, and a worst-case bound on the coarse
inverse-mapping grid's bilinear interpolation error vs the exact host f64
mapping (the role of GDAL's approximate-transformer tolerance, 0.125 px).
"""
import numpy as np
import pytest

import fixtures
from sarpro_tpu import api
from sarpro_tpu.errors import ProcessingError
from sarpro_tpu.io import geodesy
from sarpro_tpu.io import warp as warp_mod
from sarpro_tpu.io.raster import RasterReader
from sarpro_tpu.io.safe import SafeReader, parse_comprehensive_metadata
from sarpro_tpu.io.tiffio import TiffReader, TiffWriter
from sarpro_tpu.params import ProcessingParams
from sarpro_tpu.types import AutoscaleStrategy, Polarization


# ---------------------------------------------------------------------------
# Annotation geolocation grid as a TPS source
# ---------------------------------------------------------------------------
def test_geolocation_grid_parsed_from_annotation(tmp_path):
    base = fixtures.make_safe(tmp_path, name="gg.SAFE", pols=("vv",),
                              with_geolocation_grid=True)
    meta = parse_comprehensive_metadata(base)
    grid = meta.geolocation_grid
    assert grid is not None and grid.shape == (25, 4)
    # corners of the 5x5 lattice: [pixel, line, lon, lat]
    rows, cols = 96, 128
    assert grid[0].tolist() == [0.0, 0.0, 11.0, 46.0]
    assert grid[-1].tolist() == [cols - 1.0, rows - 1.0, 11.25, 45.75]


def test_geolocation_grid_absent_by_default(tmp_path):
    base = fixtures.make_safe(tmp_path, name="nogg.SAFE", pols=("vv",))
    assert parse_comprehensive_metadata(base).geolocation_grid is None


def test_warp_tps_from_geolocation_grid(tmp_path):
    """A GCP-less measurement TIFF warps via the annotation grid, and the
    result matches the TIFF-GCP warp of the identical scene bit-for-bit
    (same lattice -> same TPS)."""
    kw = dict(pols=("vv",), seed=11, with_geolocation_grid=True)
    base_gg = fixtures.make_safe(tmp_path / "a", name="gg.SAFE",
                                 tiff_gcps=False, **kw)
    base_gcp = fixtures.make_safe(tmp_path / "b", name="gcp.SAFE",
                                  tiff_gcps=True, **kw)
    params = ProcessingParams(
        polarization=Polarization.VV, autoscale=AutoscaleStrategy.STANDARD,
        size=64, target_crs="EPSG:4326", resample_alg="bilinear",
    )
    out_gg = tmp_path / "gg.tiff"
    out_gcp = tmp_path / "gcp.tiff"
    api.process_safe_to_path(base_gg, out_gg, params)
    api.process_safe_to_path(base_gcp, out_gcp, params)

    gi = TiffReader(out_gg).geo_info()
    assert gi.epsg == 4326
    assert gi.geotransform[0] == pytest.approx(11.0, abs=0.01)
    assert gi.geotransform[3] == pytest.approx(46.0, abs=0.01)
    a = TiffReader(out_gg).read(1)
    b = TiffReader(out_gcp).read(1)
    np.testing.assert_array_equal(a, b)


def test_warp_without_any_geolocation_errors(tmp_path):
    base = fixtures.make_safe(tmp_path, name="bare.SAFE", pols=("vv",),
                              tiff_gcps=False)
    params = ProcessingParams(
        polarization=Polarization.VV, size=32, target_crs="EPSG:4326",
    )
    with pytest.raises(ProcessingError, match="geolocation"):
        api.process_safe_to_path(base, tmp_path / "x.tiff", params)


def test_auto_crs_from_geolocation_grid(tmp_path):
    """AUTO-CRS falls back to the annotation grid centroid when the
    measurement TIFF has no GCPs (reference reads GDAL GCPs only:
    sentinel1.rs:1659-1692)."""
    base = fixtures.make_safe(tmp_path, name="auto-gg.SAFE", pols=("vv",),
                              tiff_gcps=False, with_geolocation_grid=True)
    assert geodesy.resolve_auto_target_crs(base) == "EPSG:32632"


# ---------------------------------------------------------------------------
# Suggested-resolution output grids vs analytic mappings
# ---------------------------------------------------------------------------
def _affine_reader(tmp_path, rows=200, cols=160, res=10.0):
    """EPSG:32632 source with exact affine georeferencing (analytic truth)."""
    rng = np.random.default_rng(3)
    dn = rng.integers(1, 60000, (rows, cols)).astype(np.uint16)
    path = tmp_path / "affine.tiff"
    w = TiffWriter(path)
    w.set_geotransform([500000.0, res, 0.0, 5100000.0, 0.0, -res])
    w.set_projection("EPSG:32632")
    w.write([dn])
    return RasterReader(path)


def test_suggested_resolution_affine_identityish(tmp_path):
    """UTM->UTM-neighbor warp with target_size=None must preserve the source
    ground sampling (gdalwarp suggested-resolution behavior)."""
    res = 10.0
    reader = _affine_reader(tmp_path, res=res)
    plan = warp_mod.plan_warp(reader, "EPSG:32633", target_size=None)
    gt = plan.geotransform
    # zone 32 -> 33 at ~46N: mild shear/scale; resolution within 3%
    assert gt[1] == pytest.approx(res, rel=0.03)
    assert -gt[5] == pytest.approx(res, rel=0.03)
    # bbox covers the reprojected source corners
    lon, lat = geodesy.project_inverse(
        np.array([500000.0, 500000.0 + 160 * res]),
        np.array([5100000.0, 5100000.0 - 200 * res]), 32632)
    x33, y33 = geodesy.project_forward(lon, lat, 32633)
    assert gt[0] <= x33.min() and gt[0] + gt[1] * plan.out_cols >= x33.max()
    assert gt[3] >= y33.max() and gt[3] + gt[5] * plan.out_rows <= y33.min()
    reader.close()


def test_suggested_resolution_gcp_lattice(tmp_path):
    """GCP/TPS source: suggested resolution must match the analytic ground
    sampling of the fixture lattice (span_deg over the pixel span)."""
    base = fixtures.make_safe(tmp_path, name="sr.SAFE", pols=("vv",))
    tif = base / "measurement" / "s1a-iw-grd-vv-001.tiff"
    reader = RasterReader(tif)
    plan = warp_mod.plan_warp(reader, "EPSG:4326", target_size=None)
    gt = plan.geotransform
    rows, cols = 96, 128
    # fixture mapping: lon spans 0.25 deg over (cols-1) px, lat over (rows-1);
    # the heuristic suggests a SQUARE pixel at the mean axis sampling (like
    # gdalwarp's SuggestedWarpOutput)
    res = (0.25 / (cols - 1) + 0.25 / (rows - 1)) / 2.0
    assert gt[1] == pytest.approx(res, rel=0.05)
    assert -gt[5] == pytest.approx(res, rel=0.05)
    assert gt[0] == pytest.approx(11.0, abs=res)
    assert gt[3] == pytest.approx(46.0, abs=res)
    reader.close()


# ---------------------------------------------------------------------------
# Inverse-mapping grid interpolation error bound
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("target", ["EPSG:4326", "EPSG:32632", "EPSG:3857",
                                    "EPSG:3413", "EPSG:3035"])
def test_mapping_grid_displacement_bound(tmp_path, target):
    """The device sampler bilinearly upsamples a coarse inverse-mapping grid;
    its worst-case displacement vs the exact f64 mapping must stay below
    GDAL's approximate-transformer tolerance (0.125 px) with margin."""
    base = fixtures.make_safe(tmp_path, name=f"db-{target[5:]}.SAFE",
                              pols=("vv",))
    tif = base / "measurement" / "s1a-iw-grd-vv-001.tiff"
    reader = RasterReader(tif)
    plan = warp_mod.plan_warp(reader, target, target_size=None)
    # dense probe lattice of output pixels (incl. off-grid-node positions)
    ys = np.linspace(0.0, plan.out_rows - 1.0, 73)
    xs = np.linspace(0.0, plan.out_cols - 1.0, 73)
    xx, yy = np.meshgrid(xs, ys)
    ex, ey = plan.exact_source_pixels(xx.ravel(), yy.ravel())
    ix, iy = plan.interp_source_pixels(xx.ravel(), yy.ravel())
    disp = np.hypot(ix - ex, iy - ey)
    assert disp.max() < 0.1, f"max displacement {disp.max():.4f} px"
    reader.close()


def test_mapping_grid_displacement_bound_suggested_vs_ts(tmp_path):
    """`-ts`-style sizing (target_size) shrinks the output grid; the mapping
    grid must stay sub-0.1 px there too (coarser output -> fewer grid cells)."""
    base = fixtures.make_safe(tmp_path, name="db-ts.SAFE", pols=("vv",))
    tif = base / "measurement" / "s1a-iw-grd-vv-001.tiff"
    reader = RasterReader(tif)
    plan = warp_mod.plan_warp(reader, "EPSG:4326", target_size=48)
    assert max(plan.out_rows, plan.out_cols) == 48
    ys = np.linspace(0.0, plan.out_rows - 1.0, 49)
    xs = np.linspace(0.0, plan.out_cols - 1.0, 49)
    xx, yy = np.meshgrid(xs, ys)
    ex, ey = plan.exact_source_pixels(xx.ravel(), yy.ravel())
    ix, iy = plan.interp_source_pixels(xx.ravel(), yy.ravel())
    assert np.hypot(ix - ex, iy - ey).max() < 0.1
    reader.close()


def test_reader_metadata_warp_still_reports_dims(tmp_path):
    """Full open path through SafeReader with the geolocation-grid TPS:
    metadata dims reflect the warped output."""
    base = fixtures.make_safe(tmp_path, name="dims.SAFE", pols=("vv",),
                              tiff_gcps=False, with_geolocation_grid=True)
    reader = SafeReader.open_with_options(
        base, "vv", target_crs="EPSG:4326", resample_alg="bilinear",
        target_size=40,
    )
    assert max(reader.metadata.lines, reader.metadata.samples) == 40
    assert reader.metadata.crs and "4326" in reader.metadata.crs
