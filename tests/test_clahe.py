"""Golden tests: CLAHE vs the direct per-pixel oracle.

Note on tolerances: the reference computes in f64 end-to-end; the device path is
f32. A single f32/f64 histogram-bin flip in a small tile shifts that tile's
whole CDF by 1/tile_pixels, so the exact-match comparison feeds the *device*
normalized image into the oracle (stages 2-3 then see identical values and
must agree to quantization), while full-f64-vs-f32 drift is covered by a
looser distributional check.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import oracle
from sarpro_tpu.core import clahe, pipeline
from sarpro_tpu.core.stats import ScaleWindow
from sarpro_tpu.types import AutoscaleStrategy, BitDepth
from test_stats import sar_like


@pytest.mark.parametrize("shape", [(64, 64), (37, 53), (80, 24)])
def test_clahe_matches_oracle_on_same_norm(rng, shape):
    """Device tile-hist + CDF + bilinear-apply vs oracle on identical input."""
    x = sar_like(rng, shape)
    db_o, valid_o = oracle.db_and_mask(x)
    s_o = oracle.histogram_stats(db_o, valid_o)
    low, high, _ = oracle.advanced_window(s_o, "clahe")
    rng_w = max(high - low, 1.0)

    db, mask, _st = pipeline.compute_db_and_stats(x)
    rows, cols = shape
    tile_h = -(-rows // 8)
    tile_w = -(-cols // 8)
    norm_d, hists_d = clahe._normalize_and_tile_hists(
        db, mask, jnp.float32(low), jnp.float32(high), jnp.float32(rng_w),
        tile_h, tile_w,
    )
    cdfs = clahe._clip_redistribute_cdf(np.asarray(hists_d), rows, cols, tile_h, tile_w)
    got = np.asarray(
        clahe._apply_cdfs(norm_d, mask, jnp.asarray(cdfs, jnp.float32),
                          jnp.float32(65535.0), tile_h, tile_w)
    )

    # Oracle on the device-computed norm: same values -> same bins -> same CDFs
    norm_host = np.asarray(norm_d, np.float64)
    valid = np.asarray(mask)
    eq_o = oracle.clahe_equalize_normalized(norm_host, valid)
    want = np.where(valid, np.trunc(np.clip(eq_o, 0, 1) * 65535.0), 0).astype(np.uint16)

    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    # f32 CDF storage + f32 bilinear => ±2 levels; bin flips ~2^-24/pixel
    assert (diff <= 2).mean() >= 0.999, f"{(diff > 2).mean():.4%} pixels off"
    assert np.median(diff) <= 1


def test_clip_redistribute_cdf_exact(rng):
    """Host clip/redistribute/CDF is bit-faithful on identical integer hists."""
    rows, cols = 200, 310
    tile_h, tile_w = 25, 39
    hists = rng.integers(0, 60, size=(64, 256)).astype(np.int32)
    got = clahe._clip_redistribute_cdf(hists.reshape(-1), rows, cols, tile_h, tile_w)

    want = np.zeros((64, 256))
    for ty in range(8):
        r0, r1 = ty * tile_h, min((ty + 1) * tile_h, rows)
        for tx in range(8):
            c0, c1 = tx * tile_w, min((tx + 1) * tile_w, cols)
            h = hists[ty * 8 + tx].astype(np.float64).copy()
            avg = ((r1 - r0) * (c1 - c0)) / 256
            thr = max(2.0 * avg, 1.0)
            excess = 0.0
            for b in range(256):
                if h[b] > thr:
                    excess += h[b] - thr
                    h[b] = np.trunc(thr)
            add = np.floor(excess / 256)
            rem = int(oracle.rust_round(excess - add * 256))
            h = np.trunc(h + add)
            b = 0
            while rem > 0:
                h[b] += 1
                b = (b + 1) % 256
                rem -= 1
            total = max(h.sum(), 1.0)
            want[ty * 8 + tx] = np.clip(np.cumsum(h) / total, 0, 1)
    np.testing.assert_allclose(got, want, atol=0, rtol=0)


def test_clahe_invalid_pixels_zero(rng):
    x = sar_like(rng, (40, 40), zeros_frac=0.3)
    res = pipeline.process_scalar_data_pipeline(x, BitDepth.U16, AutoscaleStrategy.CLAHE)
    got = np.asarray(res.scaled_u16)
    _db, valid = oracle.db_and_mask(x)
    assert np.all(got[~valid] == 0)


def test_clahe_full_strategy_distribution(rng):
    """End-to-end f32 CLAHE vs f64 oracle: distributions must match closely
    even where individual bin flips move pixels."""
    x = sar_like(rng, (256, 256), zeros_frac=0.02)
    db_o, valid_o = oracle.db_and_mask(x)
    want = oracle.autoscale_db_image_advanced(db_o, valid_o, 65535.0, "clahe")
    res = pipeline.process_scalar_data_pipeline(x, BitDepth.U16, AutoscaleStrategy.CLAHE)
    got = np.asarray(res.scaled_u16)
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    # f32 window shift (<= half a histogram bin) moves ~1% of pixels across a
    # CLAHE bin boundary; each such flip costs at most one CDF step
    # (clip_limit/num_bins = 0.78% -> 512 u16 = ±2 u8 levels). Bound both.
    assert (diff <= 64).mean() >= 0.98
    assert diff.max() <= 600
    assert np.median(diff) <= 2
