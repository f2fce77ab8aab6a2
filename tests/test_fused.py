"""Tests: the fully-fused single-program pipeline vs the exact-mode pipeline."""
import numpy as np
import pytest

from sarpro_tpu.core import fused, pipeline
from sarpro_tpu.core.synthetic_rgb import (
    create_synthetic_rgb,
    create_synthetic_rgb_suppressed,
)
from sarpro_tpu.types import AutoscaleStrategy, BitDepth
from test_stats import sar_like


@pytest.mark.parametrize(
    "strategy",
    [AutoscaleStrategy.STANDARD, AutoscaleStrategy.ROBUST,
     AutoscaleStrategy.ADAPTIVE, AutoscaleStrategy.EQUALIZED,
     AutoscaleStrategy.TAMED, AutoscaleStrategy.DEFAULT,
     AutoscaleStrategy.CLAHE],
)
def test_fused_grayscale_matches_exact_path(rng, strategy):
    x = sar_like(rng, (96, 128))
    got = np.asarray(fused.grayscale_pipeline(
        x, strategy=strategy, bit_depth=BitDepth.U16, target_size=None
    ))
    res = pipeline.process_scalar_data_pipeline(x, BitDepth.U16, strategy)
    want = np.asarray(res.scaled_u16)
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    # fused uses f32 percentile inversion (vs host f64): sub-bin agreement.
    # CLAHE on tiny test tiles (192 px) amplifies single bin flips to one CDF
    # step (~1/192 of full scale), so its bound is correspondingly looser.
    assert np.median(diff) <= 1
    if strategy is AutoscaleStrategy.CLAHE:
        assert (diff <= 4).mean() >= 0.95, f"{(diff > 4).mean():.3%} off"
        assert (diff <= 700).all()
    else:
        assert (diff <= 4).mean() >= 0.99, f"{(diff > 4).mean():.3%} off"


def test_fused_grayscale_u8(rng):
    x = sar_like(rng, (64, 64))
    got = np.asarray(fused.grayscale_pipeline(
        x, strategy=AutoscaleStrategy.ROBUST, bit_depth=BitDepth.U8
    ))
    res = pipeline.process_scalar_data_pipeline(x, BitDepth.U8, AutoscaleStrategy.ROBUST)
    want = np.asarray(res.scaled_u8)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff <= 1).mean() >= 0.99


def test_fused_synrgb_default_mode(rng):
    vv = sar_like(rng, (64, 96))
    vh = sar_like(rng, (64, 96))
    got = np.asarray(fused.synrgb_pipeline(
        vv, vh, strategy=AutoscaleStrategy.ROBUST, target_size=None
    ))
    # exact path
    r1 = pipeline.process_scalar_data_pipeline(vv, BitDepth.U8, AutoscaleStrategy.ROBUST)
    r2 = pipeline.process_scalar_data_pipeline(vh, BitDepth.U8, AutoscaleStrategy.ROBUST)
    want = np.asarray(create_synthetic_rgb(r1.scaled_u8, r2.scaled_u8))
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff <= 2).mean() >= 0.99


def test_fused_synrgb_suppressed_and_pad(rng):
    vv = sar_like(rng, (48, 96))
    vh = sar_like(rng, (48, 96))
    got = np.asarray(fused.synrgb_pipeline(
        vv, vh, strategy=AutoscaleStrategy.TAMED, target_size=None, pad=True
    ))
    assert got.shape == (96, 96, 3)
    # exact path with pre-composition padding
    from sarpro_tpu.core.resize import add_padding_to_square

    r1 = pipeline.process_scalar_data_pipeline(vv, BitDepth.U8, AutoscaleStrategy.TAMED)
    b1 = pipeline.autoscale_db_image_tamed_synrgb_u8(r1.db, r1.mask, r1.stats, True)
    r2 = pipeline.process_scalar_data_pipeline(vh, BitDepth.U8, AutoscaleStrategy.TAMED)
    b2 = pipeline.autoscale_db_image_tamed_synrgb_u8(r2.db, r2.mask, r2.stats, False)
    p1, _ = add_padding_to_square(b1, None, 96, 48, BitDepth.U8)
    p2, _ = add_padding_to_square(b2, None, 96, 48, BitDepth.U8)
    want = np.asarray(create_synthetic_rgb_suppressed(p1, p2))
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff <= 2).mean() >= 0.99


def test_fused_downsample_on_read(rng):
    vv = sar_like(rng, (128, 96))
    vh = sar_like(rng, (128, 96))
    out = np.asarray(fused.synrgb_pipeline(
        vv, vh, strategy=AutoscaleStrategy.CLAHE, target_size=32
    ))
    assert out.shape == (32, 24, 3)
    assert out.dtype == np.uint8


def test_fused_clahe_realistic_scale_2048(rng):
    """At realistic tile occupancy (2048² → 256×256-pixel
    CLAHE tiles, 65536 px/tile) the fused f32 path must demonstrate the
    claimed ≤1-histogram-bin window placement vs the exact f64 path — no
    tiny-tile escape hatch. One CDF step at this occupancy is ≤1/65536 of
    full scale, so u16 disagreements collapse to a few quantization levels."""
    x = sar_like(rng, (2048, 2048))
    got = np.asarray(fused.grayscale_pipeline(
        x, strategy=AutoscaleStrategy.CLAHE, bit_depth=BitDepth.U16,
        target_size=None,
    ))
    res = pipeline.process_scalar_data_pipeline(
        x, BitDepth.U16, AutoscaleStrategy.CLAHE)
    want = np.asarray(res.scaled_u16)
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert np.median(diff) == 0
    # ≤1 histogram bin of window placement → ≤ one 256-bin CLAHE CDF step
    # over a 65536-px tile ≈ 16 u16 levels; allow double for bilinear mixing
    frac_tight = (diff <= 16).mean()
    assert frac_tight >= 0.999, f"{(diff > 16).mean():.5%} beyond one CDF step"
    assert (diff <= 32).all(), f"max diff {diff.max()}"


def test_synrgb_pipeline_bgr_is_reversed_rgb(rng):
    """channel_order='bgr' is exactly the RGB output with the interleave
    reversed (consumed by the cv2 JPEG writer without a host swap)."""
    vv = rng.integers(0, 60000, (96, 80)).astype(np.uint16)
    vh = rng.integers(0, 30000, (96, 80)).astype(np.uint16)
    rgb = np.asarray(fused.synrgb_pipeline(
        vv, vh, strategy=AutoscaleStrategy.CLAHE, target_size=64, pad=True))
    bgr = np.asarray(fused.synrgb_pipeline(
        vv, vh, strategy=AutoscaleStrategy.CLAHE, target_size=64, pad=True,
        channel_order="bgr"))
    np.testing.assert_array_equal(bgr, rgb[..., ::-1])
