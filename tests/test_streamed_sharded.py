"""Row-sharded streamed big-scene path vs the unsharded streamed path.

core/streamed.py's `mesh` mode runs ONE shard_map program per band with
collectives at the reduction points (psum for integer histograms / counts /
moments, pmin/pmax for extrema) and GLOBAL row offsets into the CLAHE tile
geometry. Integer reductions and min/max combine exactly, so every strategy
except Adaptive must be BYTE-IDENTICAL to the unsharded scan; Adaptive's
window thresholds read mean/std whose f32 summation order differs across
shards — tolerance there (same contract as tests/test_sharded.py).

Sizes are chosen so each shard's local block has multiple chunks plus a
ragged tail, and CLAHE tiles straddle shard boundaries (416 rows / 8 shards
= 52 local rows vs tile_h = ceil(416/8) = 52 — offset by the chunk size 24
the per-chunk tile windows cut mid-tile everywhere).
"""
import numpy as np
import pytest

from sarpro_tpu.core import streamed
from sarpro_tpu.parallel.mesh import make_mesh
from sarpro_tpu.types import AutoscaleStrategy, BitDepth
from test_stats import sar_like


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, shape=(1, 8))


@pytest.mark.parametrize(
    "strategy",
    [AutoscaleStrategy.CLAHE, AutoscaleStrategy.ROBUST,
     AutoscaleStrategy.STANDARD, AutoscaleStrategy.EQUALIZED,
     AutoscaleStrategy.TAMED, AutoscaleStrategy.DEFAULT],
)
def test_sharded_streamed_synrgb_bit_identical(rng, mesh, strategy):
    vv = sar_like(rng, (416, 176))
    vh = sar_like(rng, (416, 176))
    want = np.asarray(streamed.synrgb_streamed(
        vv, vh, strategy=strategy, chunk_rows=24))
    got = np.asarray(streamed.synrgb_streamed(
        vv, vh, strategy=strategy, chunk_rows=24, mesh=mesh))
    np.testing.assert_array_equal(got, want)


def test_sharded_streamed_synrgb_pad_suppressed(rng, mesh):
    """pad precedes the suppressed composition; the combined histogram's
    pad-zero adjustment must match with shard-psum'd band histograms."""
    vv = sar_like(rng, (416, 176))
    vh = sar_like(rng, (416, 176))
    want = np.asarray(streamed.synrgb_streamed(
        vv, vh, strategy=AutoscaleStrategy.CLAHE, pad=True, chunk_rows=24))
    got = np.asarray(streamed.synrgb_streamed(
        vv, vh, strategy=AutoscaleStrategy.CLAHE, pad=True, chunk_rows=24,
        mesh=mesh))
    np.testing.assert_array_equal(got, want)


def test_sharded_streamed_synrgb_dct_layout(rng, mesh):
    """layout='dct' appends the chunked JPEG front-end on the sharded RGB —
    coefficients must be the exact ints of the unsharded run."""
    vv = sar_like(rng, (416, 176))
    vh = sar_like(rng, (416, 176))
    want = streamed.synrgb_streamed(
        vv, vh, strategy=AutoscaleStrategy.ROBUST, chunk_rows=24,
        layout="dct")
    got = streamed.synrgb_streamed(
        vv, vh, strategy=AutoscaleStrategy.ROBUST, chunk_rows=24,
        layout="dct", mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("bit_depth", [BitDepth.U8, BitDepth.U16])
def test_sharded_streamed_grayscale_bit_identical(rng, mesh, bit_depth):
    dn = sar_like(rng, (416, 176))
    want = np.asarray(streamed.grayscale_streamed(
        dn, strategy=AutoscaleStrategy.CLAHE, bit_depth=bit_depth,
        chunk_rows=24))
    got = np.asarray(streamed.grayscale_streamed(
        dn, strategy=AutoscaleStrategy.CLAHE, bit_depth=bit_depth,
        chunk_rows=24, mesh=mesh))
    np.testing.assert_array_equal(got, want)


def test_sharded_streamed_adaptive_bit_identical(rng, mesh):
    """Adaptive's mean/std derive from the psum'd integer histogram
    (fused._stats_finalize), so the sharded scan is byte-identical to the
    unsharded one — the last strategy asterisk."""
    dn = sar_like(rng, (416, 176))
    want = np.asarray(streamed.grayscale_streamed(
        dn, strategy=AutoscaleStrategy.ADAPTIVE, chunk_rows=24))
    got = np.asarray(streamed.grayscale_streamed(
        dn, strategy=AutoscaleStrategy.ADAPTIVE, chunk_rows=24, mesh=mesh))
    np.testing.assert_array_equal(got, want)


def test_sharded_streamed_masked_shard(rng, mesh):
    """A shard whose rows are ALL masked (DN=0 → dB below the -50 floor)
    must not poison the global min/max — the raw ±inf accumulators combine
    across shards BEFORE the empty-band normalization."""
    dn = np.asarray(sar_like(rng, (416, 176))).copy()
    dn[0:52] = 0.0  # exactly shard 0's block
    want = np.asarray(streamed.grayscale_streamed(
        dn, strategy=AutoscaleStrategy.STANDARD, chunk_rows=24))
    got = np.asarray(streamed.grayscale_streamed(
        dn, strategy=AutoscaleStrategy.STANDARD, chunk_rows=24, mesh=mesh))
    np.testing.assert_array_equal(got, want)


def test_sharded_streamed_odd_rows_falls_back(rng, mesh, caplog):
    """Rows that don't split evenly over the 'row' axis run unsharded with
    a warning — output still exact."""
    import logging

    dn = sar_like(rng, (409, 176))
    want = np.asarray(streamed.grayscale_streamed(
        dn, strategy=AutoscaleStrategy.CLAHE, chunk_rows=24))
    with caplog.at_level(logging.WARNING, logger="sarpro"):
        got = np.asarray(streamed.grayscale_streamed(
            dn, strategy=AutoscaleStrategy.CLAHE, chunk_rows=24, mesh=mesh))
    np.testing.assert_array_equal(got, want)
    assert any("running unsharded" in r.message for r in caplog.records)


def test_fast_path_big_scene_with_mesh_routes_to_sharded_streamed(
        tmp_path, monkeypatch, rng):
    """shard-devices + big scene must take the row-sharded STREAMED route
    (the whole-block shard_map would materialize full local f32
    intermediates), and the bytes must match the unsharded run."""
    import sarpro_tpu.core.streamed as streamed_mod
    from sarpro_tpu.core import fast_path
    from sarpro_tpu.types import BitDepth, OutputFormat

    monkeypatch.setattr(streamed_mod, "BIG_SCENE_PIXELS", 100)
    seen = {}
    real = streamed_mod.synrgb_streamed

    def spy(*a, **k):
        seen["mesh"] = k.get("mesh")
        return real(*a, **k)

    monkeypatch.setattr(streamed_mod, "synrgb_streamed", spy)
    dn1 = rng.integers(1, 60000, (48, 64)).astype(np.uint16)
    dn2 = rng.integers(1, 60000, (48, 64)).astype(np.uint16)
    ref = tmp_path / "ref.jpg"
    shd = tmp_path / "shd.jpg"
    fast_path.save_multiband_fast(
        dn1, dn2, ref, OutputFormat.JPEG, BitDepth.U8, None,
        strategy=AutoscaleStrategy.CLAHE)
    fast_path.save_multiband_fast(
        dn1, dn2, shd, OutputFormat.JPEG, BitDepth.U8, None,
        strategy=AutoscaleStrategy.CLAHE, shard_devices=8)
    assert seen.get("mesh") is not None
    assert ref.read_bytes() == shd.read_bytes()


def test_fast_path_big_gray_with_mesh(tmp_path, monkeypatch, rng):
    import sarpro_tpu.core.streamed as streamed_mod
    from sarpro_tpu.core import fast_path
    from sarpro_tpu.io.tiffio import TiffReader
    from sarpro_tpu.types import BitDepth, OutputFormat

    monkeypatch.setattr(streamed_mod, "BIG_SCENE_PIXELS", 100)
    dn = rng.integers(1, 60000, (48, 64)).astype(np.uint16)
    ref = tmp_path / "ref.tiff"
    shd = tmp_path / "shd.tiff"
    fast_path.save_single_band_fast(
        dn, ref, OutputFormat.TIFF, BitDepth.U16, None,
        strategy=AutoscaleStrategy.ROBUST)
    fast_path.save_single_band_fast(
        dn, shd, OutputFormat.TIFF, BitDepth.U16, None,
        strategy=AutoscaleStrategy.ROBUST, shard_devices=8)
    assert np.array_equal(TiffReader(ref).read(1), TiffReader(shd).read(1))
