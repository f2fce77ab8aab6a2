"""Tests: --fast mode (fused single-program pipeline behind the file API)."""
import json

import numpy as np
import pytest
from PIL import Image

import fixtures
from sarpro_tpu import api, cli
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
    return fixtures.make_safe(tmp_path_factory.mktemp("fastsafe"))


def test_fast_vs_exact_tiff_u16(safe_dir, tmp_path):
    params = ProcessingParams(
        bit_depth=BitDepthArg.U16, polarization=Polarization.VV,
        autoscale=AutoscaleStrategy.ROBUST, size=64,
    )
    exact = tmp_path / "exact.tiff"
    fast = tmp_path / "fast.tiff"
    api.process_safe_to_path(safe_dir, exact, params)
    api.process_safe_to_path(safe_dir, fast, params, fast=True)
    a = TiffReader(exact).read(1).astype(np.int64)
    b = TiffReader(fast).read(1).astype(np.int64)
    assert a.shape == b.shape == (48, 64)
    diff = np.abs(a - b)
    # fast mode folds the resize differently only when resizing the
    # quantized image; at read-target sizes both paths skip resize, leaving
    # only the f32 percentile inversion difference
    assert np.median(diff) <= 1
    assert (diff <= 64).mean() >= 0.99
    # metadata parity
    md_a = TiffReader(exact).gdal_metadata()
    md_b = TiffReader(fast).gdal_metadata()
    assert md_a["POLARIZATIONS"] == md_b["POLARIZATIONS"] == "VV"


def test_fast_synrgb_jpeg_with_pad(safe_dir, tmp_path):
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.TAMED, size=64, pad=True,
    )
    out = tmp_path / "fast_rgb.jpg"
    api.process_safe_to_path(safe_dir, out, params, fast=True)
    im = Image.open(out)
    assert im.size == (64, 64) and im.mode == "RGB"
    side = json.loads(out.with_suffix(".json").read_text())
    assert side["polarizations"] == "MULTIBAND(VV, VH)"
    assert side["synthetic_rgb_mode"] == "Default"
    assert (tmp_path / "fast_rgb.jgw").exists()


def test_fast_polar_op(safe_dir, tmp_path):
    params = ProcessingParams(
        polarization=Polarization.OP(PolarizationOperation.RATIO),
        autoscale=AutoscaleStrategy.ADAPTIVE, size=32,
    )
    out = tmp_path / "fast_ratio.tiff"
    api.process_safe_to_path(safe_dir, out, params, fast=True)
    r = TiffReader(out)
    assert r.gdal_metadata()["POLARIZATIONS"] == "RATIO(VV, VH)"


def test_cli_fast_flag(safe_dir, tmp_path):
    out = tmp_path / "clif.tiff"
    rc = cli.run(["-i", str(safe_dir), "-o", str(out), "--fast",
                  "--autoscale", "standard", "--size", "48"])
    assert rc == 0
    assert TiffReader(out).width == 48


def test_batch_resume(tmp_path, capsys):
    indir = tmp_path / "in"
    indir.mkdir()
    fixtures.make_safe(indir, name="a.SAFE", seed=1)
    fixtures.make_safe(indir, name="b.SAFE", seed=2)
    outdir = tmp_path / "out"
    args = ["--input-dir", str(indir), "--output-dir", str(outdir),
            "--autoscale", "standard", "--size", "32"]
    assert cli.run(args) == 0
    assert "Processed: 2" in capsys.readouterr().out
    # second run with --resume skips both
    assert cli.run(args + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert "Processed: 0" in out and "Skipped: 2" in out
    # pipelined driver honors resume too
    assert cli.run(args + ["--resume", "--prefetch", "2"]) == 0
    out = capsys.readouterr().out
    assert "Processed: 0" in out and "Skipped: 2" in out


def test_fast_path_big_scene_gate_routes_to_streamed(tmp_path, monkeypatch, rng):
    """The --fast full-res route must flip to the streamed pipelines past
    the HBM budget (gate unit-covered; streamed equality tested elsewhere)."""
    import sarpro_tpu.core.streamed as streamed_mod
    from sarpro_tpu.core import fast_path
    from sarpro_tpu.types import BitDepth, OutputFormat

    monkeypatch.setattr(streamed_mod, "BIG_SCENE_PIXELS", 100)
    calls = {}
    real = streamed_mod.synrgb_streamed

    def spy(*a, **k):
        calls["hit"] = True
        return real(*a, **k)

    monkeypatch.setattr(streamed_mod, "synrgb_streamed", spy)
    dn1 = rng.integers(1, 60000, (48, 64)).astype(np.uint16)
    dn2 = rng.integers(1, 60000, (48, 64)).astype(np.uint16)
    out = tmp_path / "big.jpg"
    fast_path.save_multiband_fast(
        dn1, dn2, out, OutputFormat.JPEG, BitDepth.U8, None,
        strategy=AutoscaleStrategy.CLAHE)
    assert out.exists() and calls.get("hit")


def test_overlapped_band_staging_byte_identical(safe_dir, tmp_path,
                                                monkeypatch):
    """The overlapped pair load (band-1 program dispatched during band-2's
    read, then the split combine program) must produce the exact bytes of
    the single fused program — the cut sits at the deterministic u8 band
    boundary."""
    from sarpro_tpu.io.safe import SafeReader

    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.CLAHE, size=64, pad=True,
    )
    staged = tmp_path / "staged.jpg"
    plain = tmp_path / "plain.jpg"

    seen = {}
    orig_open = SafeReader.open_with_options.__func__

    def spy_open(cls, *a, **kw):
        seen["band_stage"] = kw.get("band_stage")
        return orig_open(cls, *a, **kw)

    monkeypatch.setattr(SafeReader, "open_with_options",
                        classmethod(spy_open))
    api.process_safe_to_path(safe_dir, staged, params, fast=True)
    assert seen["band_stage"] is not None  # overlap path actually engaged

    def no_stage_open(cls, *a, **kw):
        kw["band_stage"] = None
        return orig_open(cls, *a, **kw)

    monkeypatch.setattr(SafeReader, "open_with_options",
                        classmethod(no_stage_open))
    api.process_safe_to_path(safe_dir, plain, params, fast=True)
    assert staged.read_bytes() == plain.read_bytes()


def test_fast_multiband_engages_band_staging(tmp_path):
    """The file API's multiband fast path must actually dispatch band 1's
    device program during band 2's load. The reader
    hint is 'all_pairs', whose complete pairs must route through the
    overlapped load_pair — this asserts ENGAGEMENT (staged_band1 set), not
    just output equality, so the overlap cannot silently regress to
    sequential loads again."""
    import fixtures

    from sarpro_tpu import api
    from sarpro_tpu.io.safe import SafeReader

    base = fixtures.make_safe(tmp_path, name="st.SAFE", seed=6)
    staged = []
    orig = SafeReader.open_with_options.__func__

    def spy(cls, *a, **kw):
        r = orig(cls, *a, **kw)
        staged.append(r.staged_band1 is not None)
        return r

    try:
        SafeReader.open_with_options = classmethod(spy)
        params = ProcessingParams(
            format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
            autoscale=AutoscaleStrategy.CLAHE, size=48)
        api.process_safe_to_path(base, tmp_path / "st.jpg", params,
                                 fast=True)
    finally:
        SafeReader.open_with_options = classmethod(orig)
    assert staged == [True], staged
