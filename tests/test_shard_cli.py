"""Tests: --shard-devices (single-scene row sharding from the product
surface).

SURVEY §2.5's intra-scene TP/SP analogue was previously reachable only from
tests/benchmarks; these tests pin the CLI/API wiring on the 8-virtual-device
CPU mesh (conftest.py): sharded output must equal the unsharded fast path.
"""
import json

import numpy as np
import pytest
from PIL import Image

import fixtures
from sarpro_tpu import api
from sarpro_tpu.core import fast_path
from sarpro_tpu.io.tiffio import TiffReader
from sarpro_tpu.params import ProcessingParams
from sarpro_tpu.types import (
    AutoscaleStrategy,
    BitDepthArg,
    OutputFormat,
    Polarization,
    PolarizationOperation,
)


@pytest.fixture(scope="module")
def safe_dir(tmp_path_factory):
    return fixtures.make_safe(tmp_path_factory.mktemp("shardsafe"))


def test_shard_multiband_tiff_fullres_exact(safe_dir, tmp_path):
    """Full-res multiband TIFF (shard_map branch, per-shard histograms + psum):
    byte-identical bands vs the unsharded fast path."""
    params = ProcessingParams(
        format=OutputFormat.TIFF, bit_depth=BitDepthArg.U16,
        polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.ROBUST, size=None,
    )
    ref = tmp_path / "ref.tiff"
    shd = tmp_path / "shd.tiff"
    api.process_safe_to_path(safe_dir, ref, params, fast=True)
    api.process_safe_to_path(safe_dir, shd, params, shard_devices=8)
    r1, r2 = TiffReader(ref), TiffReader(shd)
    assert np.array_equal(r1.read(1), r2.read(1))
    assert np.array_equal(r1.read(2), r2.read(2))


def test_shard_single_band_sized_exact(safe_dir, tmp_path):
    """Resize+pad config takes the GSPMD fallback branch: exact equality."""
    params = ProcessingParams(
        bit_depth=BitDepthArg.U8, polarization=Polarization.VV,
        autoscale=AutoscaleStrategy.CLAHE, size=64, pad=True,
    )
    ref = tmp_path / "ref.tiff"
    shd = tmp_path / "shd.tiff"
    api.process_safe_to_path(safe_dir, ref, params, fast=True)
    api.process_safe_to_path(safe_dir, shd, params, shard_devices=-1)
    assert np.array_equal(TiffReader(ref).read(1), TiffReader(shd).read(1))


def test_shard_polar_op_exact(safe_dir, tmp_path):
    params = ProcessingParams(
        bit_depth=BitDepthArg.U16,
        polarization=Polarization.OP(PolarizationOperation.RATIO),
        autoscale=AutoscaleStrategy.STANDARD, size=None,
    )
    ref = tmp_path / "ref.tiff"
    shd = tmp_path / "shd.tiff"
    api.process_safe_to_path(safe_dir, ref, params, fast=True)
    api.process_safe_to_path(safe_dir, shd, params, shard_devices=4)
    assert np.array_equal(TiffReader(ref).read(1), TiffReader(shd).read(1))


def test_shard_synrgb_jpeg_sized_identical_bytes(safe_dir, tmp_path):
    """Sized synRGB JPEG: the GSPMD branch keeps the writer's preferred
    layout, so sharded and unsharded runs produce the same encoder input
    and byte-identical files (plus sidecars)."""
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.TAMED, size=64, pad=True,
    )
    ref = tmp_path / "ref.jpg"
    shd = tmp_path / "shd.jpg"
    api.process_safe_to_path(safe_dir, ref, params, fast=True)
    api.process_safe_to_path(safe_dir, shd, params, shard_devices=8)
    assert ref.read_bytes() == shd.read_bytes()
    side = json.loads(shd.with_suffix(".json").read_text())
    assert side["polarizations"] == "MULTIBAND(VV, VH)"
    assert (tmp_path / "shd.jgw").exists()


def test_shard_synrgb_jpeg_fullres_pixels(safe_dir, tmp_path):
    """Full-res synRGB goes through shard_map with interleaved RGB output
    (the host encoder then does its own color convert, so files may differ
    in rounding from the device-DCT unsharded path): compare decoded pixels
    within JPEG q100 rounding."""
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.CLAHE, size=None,
    )
    ref = tmp_path / "ref.jpg"
    shd = tmp_path / "shd.jpg"
    api.process_safe_to_path(safe_dir, ref, params, fast=True)
    api.process_safe_to_path(safe_dir, shd, params, shard_devices=8)
    a = np.asarray(Image.open(ref).convert("RGB")).astype(np.int16)
    b = np.asarray(Image.open(shd).convert("RGB")).astype(np.int16)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 5
    assert np.mean(np.abs(a - b)) < 0.5


def test_shard_mesh_fallbacks(caplog):
    import logging

    with caplog.at_level(logging.WARNING, logger="sarpro"):
        # odd row count has no even power-of-two split
        assert fast_path._build_shard_mesh(8, 97, full_res=True) is None
    assert "no even power-of-two split" in caplog.text
    # GSPMD configs need no divisibility
    mesh = fast_path._build_shard_mesh(8, 97, full_res=False)
    assert mesh is not None and mesh.shape["row"] == 8
    # more devices requested than available clamps to the mesh size
    mesh = fast_path._build_shard_mesh(64, 96, full_res=True)
    assert mesh is not None and mesh.shape["row"] <= 8


def test_shard_cli_flag(safe_dir, tmp_path, capsys):
    from sarpro_tpu import cli

    out = tmp_path / "cli_shard.tiff"
    rc = cli.run([
        "-i", str(safe_dir), "-o", str(out), "--bit-depth", "u16",
        "--autoscale", "robust", "--shard-devices", "8",
    ])
    assert rc == 0 and out.exists()
    ref = tmp_path / "cli_ref.tiff"
    rc = cli.run([
        "-i", str(safe_dir), "-o", str(ref), "--bit-depth", "u16",
        "--autoscale", "robust", "--fast",
    ])
    assert rc == 0
    assert np.array_equal(TiffReader(out).read(1), TiffReader(ref).read(1))


def test_shard_batch_directory(tmp_path):
    indir = tmp_path / "in"
    outdir = tmp_path / "out"
    indir.mkdir()
    fixtures.make_safe(indir, name="a.SAFE", seed=1)
    fixtures.make_safe(indir, name="b.SAFE", seed=2)
    params = ProcessingParams(
        bit_depth=BitDepthArg.U16, polarization=Polarization.VV,
        autoscale=AutoscaleStrategy.ROBUST, size=None,
    )
    report = api.process_directory_to_path(indir, outdir, params,
                                           shard_devices=8)
    assert report.processed == 2 and report.errors == 0
    ref = tmp_path / "ref.tiff"
    api.process_safe_to_path(indir / "a.SAFE", ref, params, fast=True)
    assert np.array_equal(TiffReader(outdir / "a.SAFE.tiff").read(1),
                          TiffReader(ref).read(1))


def test_shard_pipelined_batch_driver(tmp_path):
    """Pipelined driver + shard_devices: sharding implies fast, disables
    device-batch bucketing, and per-scene output equals the unsharded fast
    path."""
    from sarpro_tpu.parallel.batch import process_directory_pipelined

    indir = tmp_path / "in"
    outdir = tmp_path / "out"
    indir.mkdir()
    fixtures.make_safe(indir, name="a.SAFE", seed=3)
    fixtures.make_safe(indir, name="b.SAFE", seed=4)
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.TAMED, size=64, pad=True,
    )
    report = process_directory_pipelined(indir, outdir, params,
                                         prefetch=2, device_batch=4,
                                         shard_devices=8)
    assert report.processed == 2 and report.errors == 0
    ref = tmp_path / "ref.jpg"
    api.process_safe_to_path(indir / "b.SAFE", ref, params, fast=True)
    assert (outdir / "b.SAFE.jpg").read_bytes() == ref.read_bytes()


def test_shard_with_warp_exact(safe_dir, tmp_path):
    """Warp runs in the reader (host) before the sharded device compute —
    the combination must match the unsharded fast path exactly."""
    params = ProcessingParams(
        bit_depth=BitDepthArg.U8, polarization=Polarization.VV,
        autoscale=AutoscaleStrategy.ROBUST, size=64,
        target_crs="auto", resample_alg="cubic",
    )
    ref = tmp_path / "ref.tiff"
    shd = tmp_path / "shd.tiff"
    api.process_safe_to_path(safe_dir, ref, params, fast=True)
    api.process_safe_to_path(safe_dir, shd, params, shard_devices=8)
    assert np.array_equal(TiffReader(ref).read(1), TiffReader(shd).read(1))
    # georeferencing carried identically
    assert TiffReader(ref).geo_info().geotransform == \
        TiffReader(shd).geo_info().geotransform


def test_batch_shard_with_warp_matches_unsharded(tmp_path):
    """Batched --shard-devices + --target-crs: the loader threads must
    request the row-sharded warp (parallel/batch.py forwards the context
    var), and the warped, sharded output must match the unsharded fast
    path."""
    from sarpro_tpu.parallel.batch import process_directory_pipelined

    indir = tmp_path / "in"
    indir.mkdir()
    fixtures.make_safe(indir, name="w.SAFE", pols=("vv",), seed=9)
    params = ProcessingParams(
        bit_depth=BitDepthArg.U8, polarization=Polarization.VV,
        autoscale=AutoscaleStrategy.ROBUST, size=64,
        target_crs="EPSG:4326", resample_alg="cubic",
    )
    outdir = tmp_path / "out"
    report = process_directory_pipelined(indir, outdir, params,
                                         prefetch=2, shard_devices=8)
    assert report.processed == 1 and report.errors == 0
    ref = tmp_path / "ref.tiff"
    api.process_safe_to_path(indir / "w.SAFE", ref, params, fast=True)
    # sharded vs unsharded warp samplers are separately compiled and can
    # differ by one f32 ulp on FMA-sensitive shapes → at most one
    # quantization level after autoscale (see test_warp_sharded.py)
    a = TiffReader(outdir / "w.SAFE.tiff").read(1).astype(np.int32)
    b = TiffReader(ref).read(1).astype(np.int32)
    assert np.abs(a - b).max() <= 1
