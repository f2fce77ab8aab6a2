"""The dB → stats → autoscale → quantize pipeline as fused XLA programs.

Reference behavior being reproduced (see file:line cites on each function):
  * dB conversion + validity mask     — src/core/processing/pipeline.rs:8-40
  * two-pass histogram statistics     — src/core/processing/autoscale.rs:35-160
  * standard / advanced autoscale     — autoscale.rs:368-448, :452-659
  * CLAHE special path                — autoscale.rs:571-608 (kernel in clahe.py)
  * U8 double-normalization quirk     — autoscale.rs:348-364, :662-704
  * Tamed synRGB band autoscale       — autoscale.rs:710-742

Device structure: three device passes (dB+min/max, histogram+moments,
quantize) mirroring the reference's two CPU passes plus its separate quantize
loop — each pass is one fused elementwise+reduction XLA program over the
whole raster, so HBM is read the minimum number of times. The only
host↔device traffic is ~4 KB of histogram plus a handful of scalars.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..types import AutoscaleStrategy, BitDepth
from . import stats as stats_mod
from .numerics import round_half_up_nonneg, trunc_sat_u16, trunc_sat_u8
from .stats import HistogramStats, ScaleWindow

NUM_BINS = stats_mod.NUM_BINS

DB_FLOOR = 1e-10  # magnitude floor (reference: pipeline.rs:19)
DB_VALID_THRESHOLD = -50.0  # validity threshold (reference: pipeline.rs:22)


# --------------------------------------------------------------------------
# Pass 1: dB + mask + min/max/count
# --------------------------------------------------------------------------
@jax.jit
def _db_mask_minmax(x):
    """10*log10(max(v, 1e-10)) and `db > -50` mask (reference: pipeline.rs:8-40),
    fused with the min/max/count reductions of stats pass 1
    (reference: autoscale.rs:38-55)."""
    v = jnp.maximum(x.astype(jnp.float32), DB_FLOOR)
    db = 10.0 * (jnp.log(v) * np.float32(1.0 / np.log(10.0)))
    mask = db > DB_VALID_THRESHOLD
    # int32 is sufficient: largest supported raster (~704 MP) < 2^31
    count = jnp.sum(mask, dtype=jnp.int32)
    big = jnp.float32(np.inf)
    mn = jnp.min(jnp.where(mask, db, big))
    mx = jnp.max(jnp.where(mask, db, -big))
    return db, mask, count, mn, mx


# --------------------------------------------------------------------------
# Pass 2: 4096-bin histogram + shifted moments
# --------------------------------------------------------------------------
@jax.jit
def _hist_moments(db, mask, mn, mx):
    """Histogram over [min, max] with truncating bin assignment
    (reference: autoscale.rs:102-117) fused with mean/std moments.

    The reference computes Welford mean/std in pass 1; we compute
    midpoint-shifted sum/sumsq here (same two-pass count) which is
    numerically equivalent within f32 tolerance and keeps pass 1 minimal.
    """
    from ..ops import histogram

    span = mx - mn
    inv_span = jnp.where(span > 0, 1.0 / span, 0.0)
    t = jnp.clip((db - mn) * inv_span, 0.0, 1.0)
    idx = jnp.minimum((t * NUM_BINS).astype(jnp.int32), NUM_BINS - 1)
    hist = histogram(jnp.where(mask, idx, NUM_BINS), NUM_BINS)
    shift = (mn + mx) * 0.5
    d = jnp.where(mask, db - shift, 0.0)
    s1 = jnp.sum(d, dtype=jnp.float32)
    s2 = jnp.sum(d * d, dtype=jnp.float32)
    return hist, s1, s2


def compute_db_and_stats(x) -> tuple[jax.Array, jax.Array, HistogramStats]:
    """Run passes 1+2 on device; assemble HistogramStats on host.

    Equivalent of reference pipeline.rs:8-40 + autoscale.rs:35-160.
    """
    db, mask, count, mn, mx = _db_mask_minmax(jnp.asarray(x))
    count = int(count)
    if count == 0:
        return db, mask, HistogramStats.empty()
    mn_f = float(mn)
    mx_f = float(mx)
    if abs(mx_f - mn_f) < np.finfo(np.float64).eps:
        # Degenerate: all valid values equal (reference: autoscale.rs:81-100).
        # mean == the value; std == 0.
        return db, mask, HistogramStats.degenerate(count, mn_f, mn_f, 0.0)
    hist, s1, s2 = _hist_moments(db, mask, mn, mx)
    hist = np.asarray(hist).astype(np.uint64)
    shift = (mn_f + mx_f) * 0.5
    m1 = float(s1) / count
    mean = shift + m1
    var = max(float(s2) / count - m1 * m1, 0.0)
    std = float(np.sqrt(var)) if count > 1 else 0.0
    st = stats_mod.stats_from_histogram(hist, count, mn_f, mx_f, mean, std)
    return db, mask, st


# --------------------------------------------------------------------------
# Pass 3: clip-normalize-gamma-quantize
# --------------------------------------------------------------------------
@jax.jit
def _quantize_window(db, mask, low, high, rng, gamma, max_val):
    """((clip(v) - low)/range)^gamma * max_val, truncated to u16; invalid -> 0
    (reference: autoscale.rs:437-447 and :644-656)."""
    clipped = jnp.clip(db, low, high)
    norm = (clipped - low) / rng
    # exact path when gamma == 1 (XLA pow goes through exp/log)
    powed = jnp.where(gamma == 1.0, norm, jnp.power(norm, gamma))
    q = trunc_sat_u16(jnp.clip(powed * max_val, 0.0, max_val))
    return jnp.where(mask, q, jnp.uint16(0))


@jax.jit
def _scale_u16_to_u8(q):
    """Second min-max normalization used for all U8 outputs
    (reference: autoscale.rs:348-364). f32 arithmetic, round half away."""
    mn = jnp.min(q).astype(jnp.float32)
    mx = jnp.max(q).astype(jnp.float32)
    scale = jnp.where(mx > mn, 255.0 / (mx - mn), 1.0)
    val = round_half_up_nonneg((q.astype(jnp.float32) - mn) * scale)
    return jnp.clip(val, 0.0, 255.0).astype(jnp.uint8)


def scale_u16_to_u8(q) -> jax.Array:
    return _scale_u16_to_u8(jnp.asarray(q))


def _apply_window_u16(db, mask, window: ScaleWindow, bit_depth: BitDepth) -> jax.Array:
    return _quantize_window(
        db,
        mask,
        jnp.float32(window.low),
        jnp.float32(window.high),
        jnp.float32(window.range),
        jnp.float32(window.gamma),
        jnp.float32(bit_depth.max_val),
    )


# --------------------------------------------------------------------------
# Public autoscale entry points (device arrays in, device arrays out)
# --------------------------------------------------------------------------
def autoscale_db_image(db, mask, stats: HistogramStats, bit_depth: BitDepth) -> jax.Array:
    """Standard autoscale → u16-typed array at the bit-depth's scale
    (reference: autoscale.rs:368-448)."""
    if stats.valid_count == 0:
        return jnp.zeros(db.shape, jnp.uint16)
    window = stats_mod.standard_window(stats)
    return _apply_window_u16(db, mask, window, bit_depth)


def autoscale_db_image_advanced(
    db, mask, stats: HistogramStats, bit_depth: BitDepth, strategy: AutoscaleStrategy
) -> jax.Array:
    """Advanced autoscale incl. the CLAHE special path
    (reference: autoscale.rs:452-659)."""
    if stats.valid_count == 0:
        return jnp.zeros(db.shape, jnp.uint16)
    window = stats_mod.advanced_window(stats, strategy)
    if strategy is AutoscaleStrategy.CLAHE:
        from .clahe import clahe_equalize_db

        return clahe_equalize_db(db, mask, window, bit_depth)
    return _apply_window_u16(db, mask, window, bit_depth)


def autoscale_db_image_tamed_synrgb_u8(
    db, mask, stats: HistogramStats, is_copol: bool
) -> jax.Array:
    """Band-specific Tamed autoscale for synRGB (reference: autoscale.rs:710-742)."""
    if stats.valid_count == 0:
        return jnp.zeros(db.shape, jnp.uint8)
    window = stats_mod.tamed_synrgb_window(stats, is_copol)
    # inline exact clip-normalize (no gamma)
    low = jnp.float32(window.low)
    high = jnp.float32(window.high)
    rng = jnp.float32(window.range)
    clipped = jnp.clip(db, low, high)
    q = trunc_sat_u8(jnp.clip((clipped - low) / rng * 255.0, 0.0, 255.0))
    return jnp.where(mask, q, jnp.uint8(0))


# --------------------------------------------------------------------------
# Pipeline orchestration
# --------------------------------------------------------------------------
@dataclasses.dataclass
class PipelineResult:
    """Outputs of the scalar pipeline (reference returns (db, mask, u8, u16) —
    pipeline.rs:42-67). We additionally carry the stats so downstream stages
    (Tamed synRGB recompute) can reuse them without another device pass."""

    db: jax.Array
    mask: jax.Array
    stats: HistogramStats
    scaled_u8: Optional[jax.Array]  # set for U8 bit depth
    scaled_u16: Optional[jax.Array]  # set for U16 bit depth

    @property
    def shape(self):
        return self.db.shape


def process_scalar_data_pipeline(
    x, bit_depth: BitDepth, strategy: AutoscaleStrategy
) -> PipelineResult:
    """Full scalar pipeline: dB+mask then strategy-dispatched autoscale
    (reference: pipeline.rs:42-67 with the U8/U16 wrappers of
    autoscale.rs:662-704)."""
    db, mask, st = compute_db_and_stats(x)
    if strategy is AutoscaleStrategy.STANDARD:
        q = autoscale_db_image(db, mask, st, bit_depth)
    else:
        q = autoscale_db_image_advanced(db, mask, st, bit_depth, strategy)
    if bit_depth is BitDepth.U8:
        return PipelineResult(db, mask, st, scale_u16_to_u8(q), None)
    return PipelineResult(db, mask, st, None, q)
