"""Golden tests: synthetic RGB LUTs vs the per-pixel f32 oracle."""
import numpy as np

import oracle
from sarpro_tpu.core import synthetic_rgb as srgb
from sarpro_tpu.types import AutoscaleStrategy, SyntheticRgbMode


def test_default_luts_bit_exact():
    lut_r, lut_g, lut_b = srgb.default_luts()
    want = oracle.synthetic_rgb_default(
        np.arange(256, dtype=np.uint8).repeat(256).reshape(256, 256),
        np.tile(np.arange(256, dtype=np.uint8), 256).reshape(256, 256),
    )
    np.testing.assert_array_equal(lut_r, want[:, 0, 0])
    np.testing.assert_array_equal(lut_g, want[0, :, 1])
    np.testing.assert_array_equal(lut_b.reshape(256, 256), want[..., 2])


def test_default_synrgb_full_domain():
    """All 65536 (band1, band2) combinations, bit-exact."""
    b1 = np.arange(256, dtype=np.uint8).repeat(256).reshape(256, 256)
    b2 = np.tile(np.arange(256, dtype=np.uint8), 256).reshape(256, 256)
    got = np.asarray(srgb.create_synthetic_rgb(b1, b2))
    want = oracle.synthetic_rgb_default(b1, b2)
    np.testing.assert_array_equal(got, want)


def test_blue_guard_band2_zero():
    b1 = np.full((4, 4), 200, np.uint8)
    b2 = np.zeros((4, 4), np.uint8)
    got = np.asarray(srgb.create_synthetic_rgb(b1, b2))
    assert np.all(got[..., 2] == 0)


def test_suppressed_synrgb(rng):
    b1 = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    b2 = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    got = np.asarray(srgb.create_synthetic_rgb_suppressed(b1, b2))
    want = oracle.synthetic_rgb_suppressed(b1, b2)
    np.testing.assert_array_equal(got, want)


def test_suppressed_water_shortcircuit(rng):
    """Mostly-dark scene: both-below-floor pixels come out pure black."""
    b1 = rng.integers(0, 10, (64, 64)).astype(np.uint8)
    b2 = rng.integers(0, 10, (64, 64)).astype(np.uint8)
    got = np.asarray(srgb.create_synthetic_rgb_suppressed(b1, b2))
    want = oracle.synthetic_rgb_suppressed(b1, b2)
    np.testing.assert_array_equal(got, want)


def test_mode_dispatch(rng):
    """All modes alias Default; Tamed/Clahe strategies select suppressed
    (reference: synthetic_rgb.rs:72-79, :182-197)."""
    b1 = rng.integers(0, 256, (16, 16)).astype(np.uint8)
    b2 = rng.integers(0, 256, (16, 16)).astype(np.uint8)
    default = np.asarray(srgb.create_synthetic_rgb(b1, b2))
    for mode in SyntheticRgbMode:
        np.testing.assert_array_equal(
            np.asarray(srgb.create_synthetic_rgb_by_mode(mode, b1, b2)), default
        )
    suppressed = np.asarray(srgb.create_synthetic_rgb_suppressed(b1, b2))
    for strat in (AutoscaleStrategy.TAMED, AutoscaleStrategy.CLAHE):
        got = np.asarray(
            srgb.create_synthetic_rgb_by_mode_and_strategy(
                SyntheticRgbMode.DEFAULT, strat, b1, b2
            )
        )
        np.testing.assert_array_equal(got, suppressed)
    got = np.asarray(
        srgb.create_synthetic_rgb_by_mode_and_strategy(
            SyntheticRgbMode.DEFAULT, AutoscaleStrategy.ROBUST, b1, b2
        )
    )
    np.testing.assert_array_equal(got, default)
