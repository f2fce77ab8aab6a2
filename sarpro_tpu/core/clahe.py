"""CLAHE — Contrast Limited Adaptive Histogram Equalization, on device.

Reference semantics (src/core/processing/autoscale.rs:220-345, call site
:571-608): 8×8 tiles over the image, 256 bins, clip limit 2.0×average,
uniform excess redistribution with round-robin remainder, normalized CDFs,
then per-pixel bilinear interpolation between the 4 neighboring tile CDFs
with a −0.5 tile-center offset; invalid pixels → 0.

Device decomposition:
  1. device: normalize dB into [0,1] with the p01/p99 window and compute all
     64 per-tile 256-bin histograms in ONE fused scatter pass (tile id and
     bin id combine into a flat 16384-way scatter-add);
  2. host:   clip + redistribute + CDF on the tiny (64, 256) table in f64 —
     bit-faithful to the reference's integer truncations;
  3. device: per-pixel gather of 4 CDF values from the 16 KB table (cache-
     resident) + bilinear blend + quantize, one fused elementwise program.

Ragged edge tiles (rows/cols not divisible by 8) are handled by computing
per-tile extents on the host exactly like the reference's min() bounds.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..types import BitDepth
from .numerics import round_half_up_nonneg, trunc_sat_u16
from .stats import ScaleWindow

TILES_X = 8
TILES_Y = 8
CLIP_LIMIT = 2.0
CLAHE_BINS = 256


@functools.partial(jax.jit, static_argnames=("tile_h", "tile_w"))
def _normalize_and_tile_hists(db, mask, low, high, rng, tile_h: int, tile_w: int):
    """Device pass 1: window-normalize (reference: autoscale.rs:581-591) and
    per-tile histograms (reference: autoscale.rs:258-269).

    Returns (norm f32 image, hists int32 (64*256,))."""
    clipped = jnp.clip(db, low, high)
    norm = jnp.where(mask, (clipped - low) / rng, 0.0)

    rows, cols = norm.shape
    # bin = round(clamp(v,0,1) * 255), round half away (reference: :262-265)
    v = jnp.clip(norm, 0.0, 1.0)
    bin_ = round_half_up_nonneg(v * np.float32(CLAHE_BINS - 1)).astype(jnp.int32)
    bin_ = jnp.clip(bin_, 0, CLAHE_BINS - 1)
    from ..ops import tile_histogram

    bin_m = jnp.where(mask, bin_, CLAHE_BINS)
    hists = tile_histogram(bin_m.ravel(), cols, TILES_X, TILES_Y, tile_h,
                           tile_w, n_bins=CLAHE_BINS)
    return norm, hists


def _clip_redistribute_cdf(hists: np.ndarray, rows: int, cols: int,
                           tile_h: int, tile_w: int) -> np.ndarray:
    """Host pass: clip histogram at 2×average, redistribute excess uniformly
    with round-robin remainder, normalize CDF (reference: autoscale.rs:271-303).

    f64 arithmetic with the reference's exact truncating casts.
    Input: (64, 256) int counts. Output: (64, 256) f64 CDFs in [0,1].
    """
    h = hists.reshape(TILES_Y, TILES_X, CLAHE_BINS).astype(np.float64)
    # per-tile pixel extents — ragged edges via min() (reference: :247-256)
    r0 = np.arange(TILES_Y) * tile_h
    r1 = np.minimum(r0 + tile_h, rows)
    c0 = np.arange(TILES_X) * tile_w
    c1 = np.minimum(c0 + tile_w, cols)
    tile_pixels = np.maximum(r1 - r0, 0)[:, None] * np.maximum(c1 - c0, 0)[None, :]
    avg = tile_pixels.astype(np.float64) / CLAHE_BINS
    thr = np.maximum(CLIP_LIMIT * avg, 1.0)[..., None]  # (8,8,1)

    over = h > thr
    excess = np.sum(np.where(over, h - thr, 0.0), axis=-1)  # f64 (8,8)
    h = np.where(over, np.trunc(thr), h)  # `*h = clip_threshold as u32`

    add_per_bin = np.floor(excess / CLAHE_BINS)  # (8,8)
    h = np.trunc(h + add_per_bin[..., None])  # `(*h as f64 + add) as u32`
    remainder = np.floor(excess - add_per_bin * CLAHE_BINS + 0.5)  # .round(), >= 0
    # +1 to bins 0..remainder-1, wrapping (remainder <= 256)
    bin_idx = np.arange(CLAHE_BINS)[None, None, :]
    h = h + (bin_idx < remainder[..., None]).astype(np.float64)

    total = np.maximum(h.sum(axis=-1, keepdims=True), 1.0)
    cdf = np.clip(np.cumsum(h, axis=-1) / total, 0.0, 1.0)
    return cdf.reshape(TILES_Y * TILES_X, CLAHE_BINS)


@functools.partial(jax.jit, static_argnames=("tile_h", "tile_w"))
def _apply_cdfs(norm, mask, cdfs, max_val, tile_h: int, tile_w: int):
    """Device pass 2: bilinear interpolation between 4 neighbor-tile CDFs
    (reference: autoscale.rs:307-343) + quantize (reference: :595-607)."""
    from ..ops import clahe_lookup

    rows, cols = norm.shape
    bin_pos = round_half_up_nonneg(
        jnp.clip(norm, 0.0, 1.0) * np.float32(CLAHE_BINS - 1)
    ).astype(jnp.int32)
    bin_pos = jnp.clip(bin_pos, 0, CLAHE_BINS - 1)
    bin_flat = jnp.where(mask, bin_pos, CLAHE_BINS).ravel()
    eq = clahe_lookup(
        bin_flat, cdfs.reshape(TILES_Y * TILES_X, CLAHE_BINS),
        cols, TILES_X, TILES_Y, tile_h, tile_w,
    ).reshape(rows, cols)
    q = trunc_sat_u16(jnp.clip(eq, 0.0, 1.0) * max_val)
    return jnp.where(mask, q, jnp.uint16(0))


def clahe_equalize_db(db, mask, window: ScaleWindow, bit_depth: BitDepth) -> jax.Array:
    """Full CLAHE path: normalize → tile hists → (host) CDFs → apply → u16.

    Equivalent of reference autoscale.rs:571-607 (with clahe_equalize_normalized
    :220-345 inlined across the device/host split).
    """
    rows, cols = db.shape
    if rows == 0 or cols == 0:
        return jnp.zeros(db.shape, jnp.uint16)
    tile_h = -(-rows // TILES_Y)  # ceil div (reference: :235-236)
    tile_w = -(-cols // TILES_X)
    norm, hists = _normalize_and_tile_hists(
        db,
        mask,
        jnp.float32(window.low),
        jnp.float32(window.high),
        jnp.float32(window.range),
        tile_h,
        tile_w,
    )
    cdfs = _clip_redistribute_cdf(np.asarray(hists), rows, cols, tile_h, tile_w)
    return _apply_cdfs(
        norm,
        mask,
        jnp.asarray(cdfs, jnp.float32),
        jnp.float32(bit_depth.max_val),
        tile_h,
        tile_w,
    )
