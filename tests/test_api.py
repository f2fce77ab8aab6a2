"""End-to-end tests: library API over synthetic SAFE fixtures (SURVEY.md §4 item 4)."""
import json

import numpy as np
import pytest
from PIL import Image

import fixtures
from sarpro_tpu import api
from sarpro_tpu.errors import ProcessingError
from sarpro_tpu.io.tiffio import TiffReader
from sarpro_tpu.params import ProcessingParams
from sarpro_tpu.types import (
    AutoscaleStrategy,
    BitDepth,
    BitDepthArg,
    OutputFormat,
    Polarization,
    PolarizationOperation,
    SyntheticRgbMode,
)


@pytest.fixture(scope="module")
def safe_dir(tmp_path_factory):
    return fixtures.make_safe(tmp_path_factory.mktemp("safe"))


def test_process_to_path_tiff_u16(safe_dir, tmp_path):
    out = tmp_path / "out.tiff"
    params = ProcessingParams(
        bit_depth=BitDepthArg.U16, polarization=Polarization.VV,
        autoscale=AutoscaleStrategy.ROBUST, size=64,
    )
    api.process_safe_to_path(safe_dir, out, params)
    r = TiffReader(out)
    assert (r.width, r.height) == (64, 48)
    assert r.dtype == np.dtype("<u2")
    md = r.gdal_metadata()
    assert md["PLATFORM"] in ("SENTINEL-1", "S1A")
    assert md["POLARIZATIONS"] == "VV"
    assert md["PRODUCT_TYPE"] == "GRD"
    assert "CONVERSION_TIMESTAMP" in md


def test_process_to_path_jpeg_synrgb(safe_dir, tmp_path):
    out = tmp_path / "rgb.jpg"
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.CLAHE, size=64, pad=True,
    )
    api.process_safe_to_path(safe_dir, out, params)
    im = Image.open(out)
    assert im.size == (64, 64)  # padded square
    assert im.mode == "RGB"
    side = json.loads(out.with_suffix(".json").read_text())
    assert side["polarizations"] == "MULTIBAND(VV, VH)"
    assert side["synthetic_rgb_mode"] == "Default"


def test_process_to_path_polar_op(safe_dir, tmp_path):
    out = tmp_path / "ratio.tiff"
    params = ProcessingParams(
        polarization=Polarization.OP(PolarizationOperation.RATIO),
        autoscale=AutoscaleStrategy.ADAPTIVE, size=32,
    )
    api.process_safe_to_path(safe_dir, out, params)
    r = TiffReader(out)
    assert r.gdal_metadata()["POLARIZATIONS"] == "RATIO(VV, VH)"


def test_process_to_buffer_variants(safe_dir):
    img = api.process_safe_to_buffer(
        safe_dir, Polarization.VV, AutoscaleStrategy.STANDARD, BitDepth.U8,
        target_size=64, pad=False, output_format=OutputFormat.TIFF,
    )
    assert img.gray is not None and img.gray16 is None
    assert (img.width, img.height) == (64, 48)
    assert img.metadata.product_type == "GRD"

    img16 = api.process_safe_to_buffer(
        safe_dir, Polarization.MULTIBAND, AutoscaleStrategy.EQUALIZED,
        BitDepth.U16, None, False, OutputFormat.TIFF,
    )
    assert img16.gray16 is not None and img16.gray16_band2 is not None

    rgb = api.process_safe_to_buffer_with_mode(
        safe_dir, Polarization.MULTIBAND, AutoscaleStrategy.TAMED,
        BitDepth.U8, 64, False, OutputFormat.JPEG, SyntheticRgbMode.DEFAULT,
    )
    assert rgb.rgb is not None and rgb.rgb.shape == (48, 64, 3)


def test_load_polarization_and_operation(safe_dir):
    data, meta = api.load_polarization(safe_dir, Polarization.VH)
    assert np.asarray(data).shape == (96, 128)
    assert meta.polarizations == ["VH"]
    with pytest.raises(ProcessingError):
        api.load_polarization(safe_dir, Polarization.MULTIBAND)
    data, meta = api.load_operation(safe_dir, PolarizationOperation.NDIFF)
    arr = np.asarray(data)
    # XLA may lower division as reciprocal-multiply: 1 ulp past ±1.0
    assert np.all(arr <= 1.0 + 1e-6) and np.all(arr >= -1.0 - 1e-6)


def test_batch_directory(tmp_path):
    indir = tmp_path / "in"
    indir.mkdir()
    fixtures.make_safe(indir, name="a.SAFE", seed=1)
    fixtures.make_safe(indir, name="b.SAFE", seed=2)
    fixtures.make_safe(indir, name="slc.SAFE", product_type="SLC", seed=3)
    (indir / "not_safe").mkdir()  # no annotation/measurement -> skipped
    outdir = tmp_path / "out"
    params = ProcessingParams(size=32, autoscale=AutoscaleStrategy.STANDARD)
    report = api.process_directory_to_path(indir, outdir, params, True)
    assert report.processed == 2
    assert report.skipped == 2
    assert report.errors == 0
    assert (outdir / "a.SAFE.tiff").exists()
    assert (outdir / "b.SAFE.tiff").exists()


def test_geotransform_rescale_and_worldfile(tmp_path):
    """Geotransform pad origin shift (save.rs:70-87).

    Quirk preserved from the reference: downsample-on-read (sentinel1.rs:
    1073-1109) does NOT rescale the geotransform's pixel size — save.rs only
    rescales relative to the pipeline-input dims, which are already the
    downsampled ones, so gt[1]/gt[5] keep the full-res spacing. Harmless for
    real S1 inputs (GCPs only, identity-gt guard suppresses embedding)."""
    base = fixtures.make_safe(tmp_path, name="geo.SAFE", pols=("vv",),
                              with_affine_geotransform=True)
    out = tmp_path / "g.jpg"
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.VV,
        autoscale=AutoscaleStrategy.STANDARD, size=64, pad=True,
    )
    api.process_safe_to_path(base, out, params)
    # source: 128x96, read at 64x48 (downsample-on-read), padded to 64x64
    side = json.loads(out.with_suffix(".json").read_text())
    gt = side["geotransform"]
    # save.rs:74-78 divides by the PADDED final dims: gt[1] *= 64/64,
    # gt[5] *= 48/64 — the pad inflates final_rows (reference-exact)
    assert gt[1] == pytest.approx(10.0)
    assert gt[5] == pytest.approx(-10.0 * 48 / 64)
    # pad_top = (64-48)//2 = 8 rows shift upward: gt[3] - 8*gt[5]
    assert gt[3] == pytest.approx(5100000.0 + 8 * (10.0 * 48 / 64))
    assert gt[0] == pytest.approx(500000.0)
    jgw = (tmp_path / "g.jgw").read_text().splitlines()
    assert float(jgw[0]) == pytest.approx(gt[1])
    assert float(jgw[4]) == pytest.approx(gt[0] + 0.5 * gt[1])
    assert (tmp_path / "g.prj").exists()


def test_warp_to_epsg4326(tmp_path):
    """GCP-based TPS warp to EPSG:4326 on device (gdalwarp -tps equivalent)."""
    base = fixtures.make_safe(tmp_path, name="warp.SAFE", pols=("vv",))
    out = tmp_path / "w.tiff"
    params = ProcessingParams(
        polarization=Polarization.VV, autoscale=AutoscaleStrategy.STANDARD,
        size=64, target_crs="EPSG:4326", resample_alg="bilinear",
    )
    api.process_safe_to_path(base, out, params)
    r = TiffReader(out)
    gi = r.geo_info()
    assert gi.geotransform is not None
    # bbox must cover the fixture's GCP extent (lon 11..11.25, lat 45.75..46)
    gt = gi.geotransform
    assert gt[0] == pytest.approx(11.0, abs=0.01)
    assert gt[3] == pytest.approx(46.0, abs=0.01)
    assert gi.epsg == 4326 and gi.is_geographic


def test_warp_auto_crs(tmp_path):
    base = fixtures.make_safe(tmp_path, name="auto2.SAFE", pols=("vv",))
    out = tmp_path / "a.tiff"
    params = ProcessingParams(
        polarization=Polarization.VV, autoscale=AutoscaleStrategy.STANDARD,
        size=48, target_crs="auto", resample_alg="cubic",
    )
    api.process_safe_to_path(base, out, params)
    gi = TiffReader(out).geo_info()
    assert gi.epsg == 32632  # UTM 32N from fixture centroid
    # pixel sizes should be ~meters (not degrees)
    assert abs(gi.geotransform[1]) > 1.0


def test_warp_skip_when_already_in_target(tmp_path):
    base = fixtures.make_safe(tmp_path, name="skip.SAFE", pols=("vv",),
                              with_affine_geotransform=True)
    out = tmp_path / "s.tiff"
    params = ProcessingParams(
        polarization=Polarization.VV, autoscale=AutoscaleStrategy.STANDARD,
        target_crs="EPSG:32632",
    )
    api.process_safe_to_path(base, out, params)
    gi = TiffReader(out).geo_info()
    # unchanged source geotransform (no warp happened)
    assert gi.geotransform == [500000.0, 10.0, 0.0, 5100000.0, 0.0, -10.0]


def test_warp_to_epsg3857(tmp_path):
    """--target-crs EPSG:3857 must warp, not error."""
    base = fixtures.make_safe(tmp_path, name="wm.SAFE", pols=("vv",))
    out = tmp_path / "wm.tiff"
    params = ProcessingParams(
        polarization=Polarization.VV, autoscale=AutoscaleStrategy.STANDARD,
        size=64, target_crs="EPSG:3857", resample_alg="bilinear",
    )
    api.process_safe_to_path(base, out, params)
    r = TiffReader(out)
    gi = r.geo_info()
    gt = gi.geotransform
    from sarpro_tpu.io import geodesy
    # fixture GCP extent lon 11..11.25, lat 45.75..46 → projected bbox corners
    x0, y1 = geodesy.webmercator_forward(11.0, 46.0)
    x1, y0 = geodesy.webmercator_forward(11.25, 45.75)
    assert gt[0] == pytest.approx(x0, abs=(x1 - x0) * 0.02)
    assert gt[3] == pytest.approx(y1, abs=(y1 - y0) * 0.02)
    assert gi.epsg == 3857
    # pixel data present
    a = r.read(1)
    assert a.shape[1] == 64 and a.max() > 0


def test_warp_unsupported_crs_actionable_error(tmp_path):
    base = fixtures.make_safe(tmp_path, name="bad.SAFE", pols=("vv",))
    params = ProcessingParams(
        # the round-3 national-grid family absorbed 2154/29902/5514/27572
        # and the cs2cs pipe backend absorbed every remaining PROJ-known
        # method; a nonsense code exercises the actionable error
        polarization=Polarization.VV, size=64, target_crs="EPSG:999999",
    )
    with pytest.raises(Exception, match="supported:"):
        api.process_safe_to_path(base, tmp_path / "x.tiff", params)


def test_exact_mode_big_scene_routes_to_streamed(tmp_path, monkeypatch, caplog):
    """Full-res exact mode past the HBM budget must not OOM: it reroutes to
    the streamed fast path with a warning."""
    import logging

    import sarpro_tpu.core.streamed as streamed_mod

    monkeypatch.setattr(streamed_mod, "BIG_SCENE_PIXELS", 1000)
    base = fixtures.make_safe(tmp_path, name="big.SAFE", pols=("vv",))
    out = tmp_path / "big.tiff"
    params = ProcessingParams(polarization=Polarization.VV,
                              autoscale=AutoscaleStrategy.ROBUST, size=None)
    with caplog.at_level(logging.WARNING, logger="sarpro"):
        api.process_safe_to_path(base, out, params)
    assert out.exists()
    assert any("streamed fast-mode" in r.message for r in caplog.records)
