"""Fully-fused single-program pipelines: DN → synRGB / grayscale in ONE jit.

The exact-mode pipeline (pipeline.py) splits at the data-dependent scalar
logic so percentile inversion and window selection run host-side in f64,
bit-faithful to the reference. This module is the *production fast path*: the
entire chain — downsample-on-read resampling, dB conversion, histogram
statistics, strategy window selection, CLAHE, quantization, double
normalization, synthetic RGB — is expressed in jnp so XLA compiles one
program with zero host round-trips. Scalar control flow becomes arithmetic
`jnp.where` selection (strategies are static), so there is no recompilation
across scenes of the same shape.

This is also the multi-chip target: under a `jax.sharding.Mesh` the
histogram scatter-adds become cross-device reductions and everything else
partitions cleanly (see parallel/sharded.py).

Numerics: f32 end-to-end (vs the reference's f64 on CPU) — equivalent within
≤1 histogram bin of window placement; validated against the exact path in
tests/test_fused.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..types import AutoscaleStrategy, BitDepth
from .clahe import CLAHE_BINS, CLIP_LIMIT, TILES_X, TILES_Y
from .numerics import round_half_up_nonneg
from .pipeline import DB_FLOOR, DB_VALID_THRESHOLD, NUM_BINS
from .resize import _build_coeffs  # noqa: F401 — shared coefficient cache
from .synthetic_rgb import (
    BLUE_SCALE_SUPP,
    EPS_SUPP,
    GAMMA_B,
    GAMMA_G_SUPP,
    GAMMA_R_SUPP,
    default_luts,
)

_PCT_ORDER = ("p01", "p02", "p05", "p10", "p25", "median", "p75", "p90",
              "p95", "p98", "p99")
_PCT_VALUES = np.array([0.01, 0.02, 0.05, 0.10, 0.25, 0.5, 0.75, 0.90,
                        0.95, 0.98, 0.99], np.float32)


def _db_mask(x):
    v = jnp.maximum(x.astype(jnp.float32), DB_FLOOR)
    db = 10.0 * (jnp.log(v) * np.float32(1.0 / np.log(10.0)))
    return db, db > DB_VALID_THRESHOLD


def _stats(db, mask, row_axis: str | None = None):
    """count/min/max + 4096-bin histogram + percentiles, all in-graph.

    With `row_axis` set (shard_map over row-sharded rasters), the local
    reductions become cross-shard collectives — per-shard histograms combine
    with one psum (SURVEY.md §2.5)."""
    count = jnp.sum(mask, dtype=jnp.int32)
    big = jnp.float32(np.inf)
    mn = jnp.min(jnp.where(mask, db, big))
    mx = jnp.max(jnp.where(mask, db, -big))
    if row_axis is not None:
        count = jax.lax.psum(count, row_axis)
        mn = jax.lax.pmin(mn, row_axis)
        mx = jax.lax.pmax(mx, row_axis)
    mn = jnp.where(count > 0, mn, 0.0)
    mx = jnp.where(count > 0, mx, 0.0)
    from ..ops import histogram as _hist_kernel

    hist = _hist_kernel(_db_bin_index(db, mask, mn, mx), NUM_BINS)
    if row_axis is not None:
        hist = jax.lax.psum(hist, row_axis)
    return _stats_finalize(hist, count, mn, mx)


def _db_bin_index(db, mask, mn, mx):
    """dB value → 4096-bin index (masked pixels carry the overflow index);
    shared by the fused single program and the streamed per-chunk passes so
    bin assignment stays a single source of truth."""
    span = mx - mn
    inv = jnp.where(span > 0, 1.0 / span, 0.0)
    t = jnp.clip((db - mn) * inv, 0.0, 1.0)
    idx = jnp.minimum((t * NUM_BINS).astype(jnp.int32), NUM_BINS - 1)
    return jnp.where(mask, idx, NUM_BINS)


def _clahe_norm(db, mask, low, high):
    """Masked [0,1] normalization ahead of CLAHE binning (one definition for
    fused and streamed)."""
    rng = jnp.maximum(high - low, 1.0)
    return jnp.where(mask, (jnp.clip(db, low, high) - low) / rng, 0.0)


def _tamed_quantize_u8(db, mask, low, high):
    """Band-specific tamed window straight to u8 (autoscale.rs:710-742)."""
    rng = jnp.maximum(high - low, 1.0)
    q = jnp.clip(jnp.trunc(jnp.clip(
        (jnp.clip(db, low, high) - low) / rng * 255.0, 0, 255)), 0, 255)
    return jnp.where(mask, q, 0.0)


def _stats_finalize(hist, count, mn, mx):
    """Histogram → moments + percentiles (shared by the fused single
    program, the streamed big-scene path, and the sharded variants).

    mean/std are derived FROM the int32 histogram (bin centers, Adaptive's
    only consumers) rather than from per-pixel f32 moment sums: integer
    histogram adds commute exactly, so every execution strategy — fused,
    streamed (any chunk size), row-sharded (any shard count) — computes
    byte-identical mean/std from the same (4096,) arithmetic, making
    Adaptive bit-stable across strategies (the old f32
    moment sums reordered across chunk/shard boundaries). Accuracy cost vs
    exact moments is O(bin width) = span/4096 (~0.02 dB on real scenes),
    inside the fast path's documented f32-vs-f64 tolerance; exact mode
    (core/stats.py) keeps the reference's host-f64 Welford moments."""
    span = mx - mn
    n = jnp.maximum(count.astype(jnp.float32), 1.0)
    hf = hist[:NUM_BINS].astype(jnp.float32)
    centers = jnp.arange(NUM_BINS, dtype=jnp.float32) + 0.5  # bin units
    bw_m = span / NUM_BINS
    m1 = jnp.sum(hf * centers) / n
    m2 = jnp.sum(hf * centers * centers) / n
    mean = mn + m1 * bw_m
    var = jnp.maximum(m2 - m1 * m1, 0.0) * bw_m * bw_m
    std = jnp.where(count > 1, jnp.sqrt(var), 0.0)

    # percentile inversion (reference: autoscale.rs:120-140, vectorized)
    cum = jnp.cumsum(hist)
    targets = jnp.minimum(
        jnp.floor(_PCT_VALUES * n).astype(jnp.int32), count - 1
    )
    b = jnp.searchsorted(cum, targets, side="right")
    b = jnp.minimum(b, NUM_BINS - 1)
    h = hist[b]
    cum_before = cum[b] - h
    within = jnp.maximum(targets - cum_before, 0)
    frac = jnp.where(h > 0, within.astype(jnp.float32) / h.astype(jnp.float32), 0.0)
    bw = span / NUM_BINS
    pcts = mn + (b.astype(jnp.float32) + frac) * bw
    # degenerate all-equal case: low pcts = min, high = max
    degenerate = span <= 0
    lowhigh = jnp.where(_PCT_VALUES <= 0.5, mn, mx)
    pcts = jnp.where(degenerate, lowhigh, pcts)

    d = dict(zip(_PCT_ORDER, pcts))
    d.update(count=count, min=mn, max=mx, mean=mean, std=std)
    return d


def _window(s, strategy: AutoscaleStrategy):
    """Strategy windows as scalar arithmetic (reference: autoscale.rs:404-424
    standard, :491-562 advanced)."""
    iqr = s["p75"] - s["p25"]
    if strategy is AutoscaleStrategy.STANDARD:
        dr = s["max"] - s["min"]
        rng_med = jnp.maximum(20.0, dr * 0.8)
        low1, high1, g1 = s["median"] - rng_med / 2, s["median"] + rng_med / 2, 1.1
        low2, high2, g2 = s["p25"] - 2.5 * iqr, s["p75"] + 2.5 * iqr, 1.0
        low3 = jnp.maximum(s["p02"], s["min"] + 0.02 * dr)
        high3 = jnp.minimum(s["p98"], s["max"] - 0.02 * dr)
        g3 = 0.9
        low4, high4, g4 = s["p02"], s["p98"], 1.0
        c1 = dr < 15.0
        c2 = iqr < 5.0
        c3 = dr > 40.0
        low = jnp.where(c1, low1, jnp.where(c2, low2, jnp.where(c3, low3, low4)))
        high = jnp.where(c1, high1, jnp.where(c2, high2, jnp.where(c3, high3, high4)))
        gamma = jnp.where(c1, g1, jnp.where(c2, g2, jnp.where(c3, g3, g4)))
        low = jnp.maximum(low, s["min"])
        high = jnp.minimum(high, s["max"])
        return low, high, gamma
    if strategy is AutoscaleStrategy.ROBUST:
        thr = 2.5 * iqr
        low = jnp.maximum(jnp.maximum(s["p25"] - thr, s["p01"]), s["min"])
        high = jnp.minimum(jnp.minimum(s["p75"] + thr, s["p99"]), s["max"])
        return low, high, jnp.float32(1.0)
    if strategy is AutoscaleStrategy.ADAPTIVE:
        skew = (s["mean"] - s["median"]) / jnp.maximum(jnp.abs(s["std"]), 1.0)
        tail = (s["p99"] - s["p95"]) / jnp.maximum(s["p95"] - s["p75"], 1.0)
        c_skew = jnp.abs(skew) > 0.5
        c_pos = skew > 0.0
        c_tail = tail > 2.0
        low = jnp.where(
            c_skew, jnp.where(c_pos, s["p02"], s["p05"]),
            jnp.where(c_tail, s["p10"], s["p05"]),
        )
        high = jnp.where(
            c_skew, jnp.where(c_pos, s["p98"], s["p95"]),
            jnp.where(c_tail, s["p90"], s["p95"]),
        )
        gamma = jnp.where(
            c_skew, jnp.where(c_pos, 0.9, 1.1), jnp.where(c_tail, 0.8, 1.0)
        )
        return low, high, gamma
    if strategy in (AutoscaleStrategy.EQUALIZED, AutoscaleStrategy.CLAHE):
        return s["p01"], s["p99"], jnp.float32(1.0)
    if strategy is AutoscaleStrategy.TAMED:
        return s["p25"], s["p99"], jnp.float32(1.0)
    return s["p05"], s["p95"], jnp.float32(1.0)  # default


def _quantize(db, mask, low, high, gamma, max_val):
    rng = jnp.maximum(high - low, 1.0)
    norm = (jnp.clip(db, low, high) - low) / rng
    powed = jnp.where(gamma == 1.0, norm, jnp.power(norm, gamma))
    q = jnp.clip(jnp.trunc(jnp.clip(powed * max_val, 0.0, max_val)), 0, 65535)
    return jnp.where(mask, q, 0.0).astype(jnp.uint16)


def _scale_u16_to_u8(q, row_axis: str | None = None):
    mn = jnp.min(q).astype(jnp.float32)
    mx = jnp.max(q).astype(jnp.float32)
    if row_axis is not None:
        mn = jax.lax.pmin(mn, row_axis)
        mx = jax.lax.pmax(mx, row_axis)
    scale = jnp.where(mx > mn, 255.0 / (mx - mn), 1.0)
    val = round_half_up_nonneg((q.astype(jnp.float32) - mn) * scale)
    return jnp.clip(val, 0.0, 255.0).astype(jnp.uint8)


def _clahe_bins(norm, mask, rows: int, cols: int, tile_h: int, tile_w: int,
                row_axis: str | None = None, row_offset=None):
    """Per-pixel CLAHE bin, masked pixels carrying CLAHE_BINS (the kernels'
    invalid convention). Tile membership is derived from pixel coordinates
    inside ops.tile_histogram / ops.clahe_lookup, so this stays a pure
    value→bin map (rows/cols/tile args kept for signature stability across
    the fused/streamed/sharded callers)."""
    del rows, cols, tile_h, tile_w, row_axis, row_offset
    bin_ = round_half_up_nonneg(jnp.clip(norm, 0, 1) * np.float32(CLAHE_BINS - 1))
    bin_ = jnp.clip(bin_, 0, CLAHE_BINS - 1).astype(jnp.int32)
    return jnp.where(mask, bin_, CLAHE_BINS)


def _clahe_cdfs(hists, rows_global: int, cols: int, tile_h: int, tile_w: int):
    """Tile histograms (flat int counts) → clipped/redistributed CDFs
    (reference: autoscale.rs:268-305), shared by the fused program and the
    streamed big-scene path."""
    h = hists.reshape(TILES_Y * TILES_X, CLAHE_BINS).astype(jnp.float32)
    # per-tile extents (static, global raster)
    r1 = np.minimum((np.arange(TILES_Y) + 1) * tile_h, rows_global)
    r0 = np.arange(TILES_Y) * tile_h
    c1 = np.minimum((np.arange(TILES_X) + 1) * tile_w, cols)
    c0 = np.arange(TILES_X) * tile_w
    tile_pixels = (np.maximum(r1 - r0, 0)[:, None]
                   * np.maximum(c1 - c0, 0)[None, :]).reshape(-1).astype(np.float32)
    thr = jnp.asarray(np.maximum(CLIP_LIMIT * tile_pixels / CLAHE_BINS, 1.0))[:, None]

    over = h > thr
    excess = jnp.sum(jnp.where(over, h - thr, 0.0), axis=-1, keepdims=True)
    h = jnp.where(over, jnp.trunc(thr), h)
    add = jnp.floor(excess / CLAHE_BINS)
    h = jnp.trunc(h + add)
    rem = jnp.floor(excess - add * CLAHE_BINS + 0.5)
    bin_idx = jnp.arange(CLAHE_BINS, dtype=jnp.float32)[None, :]
    h = h + (bin_idx < rem).astype(jnp.float32)
    total = jnp.maximum(jnp.sum(h, axis=-1, keepdims=True), 1.0)
    return jnp.clip(jnp.cumsum(h, axis=-1) / total, 0.0, 1.0)


def _clahe(db, mask, low, high, max_val, rows: int, cols: int,
           row_axis: str | None = None, row_shards: int = 1):
    """CLAHE entirely in-graph (cf. clahe.py for the exact-mode split).

    Row-sharded mode (`row_axis`): tile geometry is computed over the GLOBAL
    raster (rows × row_shards); each shard builds tile histograms from its
    local rows, one psum combines them, and the
    bilinear apply runs locally with the shard's global row offset — the
    tile-CDF allgather of SURVEY.md §2.5 realized as a single collective."""
    rows_global = rows * row_shards
    tile_h = -(-rows_global // TILES_Y)
    tile_w = -(-cols // TILES_X)
    norm = _clahe_norm(db, mask, low, high)

    bin_m = _clahe_bins(norm, mask, rows, cols, tile_h, tile_w,
                        row_axis=row_axis)
    from ..ops import clahe_lookup, tile_histogram

    if row_axis is not None:
        row_off = jax.lax.axis_index(row_axis).astype(jnp.int32) * rows
    else:
        row_off = None
    bin_flat = bin_m.ravel()
    hists = tile_histogram(bin_flat, cols, TILES_X, TILES_Y, tile_h, tile_w,
                           row_offset=row_off, n_bins=CLAHE_BINS)
    if row_axis is not None:
        hists = jax.lax.psum(hists, row_axis)
    cdfs = _clahe_cdfs(hists, rows_global, cols, tile_h, tile_w)

    eq = clahe_lookup(
        bin_flat, cdfs, cols, TILES_X, TILES_Y, tile_h, tile_w,
        row_offset=row_off,
    ).reshape(rows, cols)
    q = jnp.trunc(jnp.clip(eq, 0.0, 1.0) * max_val)
    return jnp.where(mask, q, 0.0).astype(jnp.uint16)


def _resample_dn(x, out_rows: int, out_cols: int, filter_name: str):
    """Downsample-on-read equivalent, in-graph (static shapes).

    The first (row) pass consumes the input's native dtype — u16 DN rasters
    stream from device memory at half the f32 traffic (the tap loop casts
    per tap)."""
    from .resize import _apply_axis0

    in_rows, in_cols = x.shape
    if in_rows != out_rows:
        x = _apply_axis0(x, filter_name, in_rows, out_rows)
    if in_cols != out_cols:
        x = _apply_axis0(x.T, filter_name, in_cols, out_cols).T
    return x.astype(jnp.float32)


def _band_u8(dn, strategy: AutoscaleStrategy, tamed_copol: bool | None,
             rows: int, cols: int, row_axis: str | None = None,
             row_shards: int = 1):
    """One band DN → final u8 (the strategy dispatch of pipeline.rs:42-67 plus
    the Tamed synRGB band path of save.rs:324-328)."""
    db, mask = _db_mask(dn)
    s = _stats(db, mask, row_axis)
    if tamed_copol is not None and strategy is AutoscaleStrategy.TAMED:
        # band-specific tamed window (autoscale.rs:710-742) straight to u8
        low = jnp.where(tamed_copol, jnp.minimum(s["p02"], s["p05"]), s["p05"])
        high = s["p99"]
        return _tamed_quantize_u8(db, mask, low, high).astype(jnp.uint8)
    low, high, gamma = _window(s, strategy)
    if strategy is AutoscaleStrategy.CLAHE:
        q16 = _clahe(db, mask, low, high, jnp.float32(255.0), rows, cols,
                     row_axis, row_shards)
    else:
        q16 = _quantize(db, mask, low, high, gamma, jnp.float32(255.0))
    return _scale_u16_to_u8(q16, row_axis)


def _synrgb_default(b1, b2):
    from ..ops import synrgb_lookup

    lut_r, lut_g, lut_b = default_luts()
    rgb = synrgb_lookup(b1.ravel(), b2.ravel(), jnp.asarray(lut_r),
                        jnp.asarray(lut_g), jnp.asarray(lut_b))
    return rgb.reshape(b1.shape + (3,))


def _suppressed_floor(hist, total_pixels):
    """Combined-histogram water floor (reference: synthetic_rgb.rs:96-110)."""
    target = jnp.floor(jnp.float32(total_pixels) * 0.05 + 0.5)
    cum = jnp.cumsum(hist).astype(jnp.float32)
    reached = cum >= target
    floor_value = jnp.where(jnp.any(reached), jnp.argmax(reached), 0)
    return jnp.minimum(floor_value + 3, 40).astype(jnp.float32)


def _suppressed_luts(floor_c):
    """Suppressed-mode r/g gamma LUTs + 2D blue LUT from the water floor
    (reference: synthetic_rgb.rs:112-158)."""
    v = jnp.arange(256, dtype=jnp.float32)
    denom = jnp.maximum(255.0 - floor_c, 1.0)
    shifted = jnp.maximum(v - floor_c, 0.0) / denom
    lut_r = jnp.where(
        v <= floor_c, 0.0,
        jnp.clip(round_half_up_nonneg(jnp.power(shifted, GAMMA_R_SUPP) * 255.0), 0, 255),
    )
    lut_g = jnp.where(
        v <= floor_c, 0.0,
        jnp.clip(round_half_up_nonneg(jnp.power(shifted, GAMMA_G_SUPP) * 255.0), 0, 255),
    )
    rr = lut_r[:, None]
    gg = lut_g[None, :]
    ratio = (rr + EPS_SUPP) / (gg + EPS_SUPP)
    lut_b = round_half_up_nonneg(
        jnp.clip(jnp.power(ratio, GAMMA_B) * 255.0 * BLUE_SCALE_SUPP, 0.0, 255.0)
    ).reshape(-1)
    return lut_r, lut_g, lut_b


def _synrgb_suppressed(b1, b2, row_axis: str | None = None,
                       row_shards: int = 1):
    """Suppressed composition with the data-dependent floor computed in-graph
    (reference: synthetic_rgb.rs:88-178)."""
    from ..ops import histogram, synrgb_lookup

    i1 = b1.astype(jnp.int32)
    i2 = b2.astype(jnp.int32)
    hist = histogram(b1, 256) + histogram(b2, 256)
    if row_axis is not None:
        hist = jax.lax.psum(hist, row_axis)
    floor_c = _suppressed_floor(hist, (b1.size + b2.size) * row_shards)
    lut_r, lut_g, lut_b = _suppressed_luts(floor_c)
    rgb = synrgb_lookup(i1.ravel(), i2.ravel(), lut_r, lut_g, lut_b)
    rgb = rgb.reshape(b1.shape + (3,))
    water = ((i1.astype(jnp.float32) <= floor_c)
             & (i2.astype(jnp.float32) <= floor_c))[..., None]
    return jnp.where(water, jnp.uint8(0), rgb)


def _pad_square(x, rows: int, cols: int):
    m = max(rows, cols)
    pr = (m - rows) // 2
    pc = (m - cols) // 2
    if x.ndim == 3:
        return jnp.pad(x, ((pr, m - rows - pr), (pc, m - cols - pc), (0, 0)))
    return jnp.pad(x, ((pr, m - rows - pr), (pc, m - cols - pc)))


def _plan_read_dims(in_rows: int, in_cols: int, target_size: int | None,
                    resample_alg: str | None = None):
    """Downsample-on-read sizing + filter choice (sentinel1.rs:1084-1102):
    user-chosen algorithm wins; otherwise Average for >=4x reduction,
    Lanczos for mild downscale."""
    if target_size is None:
        return in_rows, in_cols, None
    long_side = max(in_rows, in_cols)
    scale = min(target_size / long_side, 1.0)
    out_rows = max(int(np.floor(in_rows * scale + 0.5)), 1)
    out_cols = max(int(np.floor(in_cols * scale + 0.5)), 1)
    reduction = max(long_side / target_size, 1.0)
    filt = resample_alg or ("average" if reduction >= 4.0 else "lanczos")
    return out_rows, out_cols, filt


@functools.partial(
    jax.jit,
    static_argnames=("strategy", "target_size", "pad", "suppressed",
                     "resample_alg", "row_axis", "row_shards",
                     "channel_order"),
)
def synrgb_pipeline(
    vv_dn,
    vh_dn,
    strategy: AutoscaleStrategy = AutoscaleStrategy.CLAHE,
    target_size: int | None = 2048,
    pad: bool = False,
    suppressed: bool | None = None,
    resample_alg: str | None = None,
    row_axis: str | None = None,
    row_shards: int = 1,
    channel_order: str = "rgb",
):
    """Flagship fused program: dual-pol DN rasters → synthetic-RGB u8.

    Covers the full benchmark configuration (SURVEY.md §3.2 call stack):
    downsample-on-read → dB → stats → autoscale (strategy) → u8 → synRGB.
    One XLA program, zero host syncs.

    With `row_axis`/`row_shards` (called inside shard_map on a row-sharded
    raster): inputs are the LOCAL row blocks, reductions psum over the axis,
    and the histograms run per shard (parallel/sharded.py). Resampling
    and padding are whole-raster ops and unsupported in that mode.
    """
    b1 = _synrgb_band(vv_dn, strategy, True, target_size, pad, resample_alg,
                      row_axis, row_shards)
    b2 = _synrgb_band(vh_dn, strategy, False, target_size, pad, resample_alg,
                      row_axis, row_shards)
    return _synrgb_combine(b1, b2, strategy, suppressed, channel_order,
                           row_axis, row_shards)


def _synrgb_band(dn, strategy, copol: bool, target_size, pad: bool,
                 resample_alg=None, row_axis=None, row_shards: int = 1):
    """One band of the synRGB pipeline: resample → dB/stats/autoscale → u8
    (+ pad). Everything up to the dual-band composition — the per-band cut
    the overlapped file path dispatches while the other band is still being
    read from disk (api.py fast mode)."""
    in_rows, in_cols = dn.shape
    if row_axis is not None:
        assert target_size is None and not pad, \
            "row-sharded mode processes full-res unpadded rasters"
        rows, cols, filt = in_rows, in_cols, None
    else:
        rows, cols, filt = _plan_read_dims(in_rows, in_cols, target_size,
                                           resample_alg)
    x = (_resample_dn(dn, rows, cols, filt) if filt is not None
         else dn.astype(jnp.float32))
    tamed = strategy is AutoscaleStrategy.TAMED
    b = _band_u8(x, strategy, copol if tamed else None, rows, cols,
                 row_axis, row_shards)
    if pad:
        # padding precedes composition (save.rs:332-361): the pad zeros take
        # part in the suppressed mode's combined histogram
        b = _pad_square(b, rows, cols)
    return b


@functools.lru_cache(maxsize=1)
def _dct8_basis():
    """Orthonormal 8x8 DCT-II basis — the JPEG FDCT (matches the host
    encoder's gDctT table, native/jpegenc.cpp). NumPy (not jnp): device
    constants must not be cached across traces (tracer leak)."""
    u = np.arange(8, dtype=np.float64)
    s = np.where(u == 0, np.sqrt(1.0 / 8.0), np.sqrt(2.0 / 8.0))
    t = s[:, None] * np.cos((2.0 * u[None, :] + 1.0) * u[:, None] * np.pi / 16.0)
    return t.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _dct_pair_split():
    """Pair-of-blocks 2D-DCT operator as three bf16 terms (hi + residuals).

    The per-block 2D FDCT in the host's transposed layout is one 64x64
    linear map: out[(i*8+j)] = sum_{l,k} T[i,k]*T[j,l] * blk[l,k]. Two
    horizontally adjacent blocks share a (128,128) block-diagonal operator
    so the contraction is one 128-wide matrix product instead of two K=8
    contractions.

    Input-row order: the operator's rows are ordered [(col-in-pair kk)*8 +
    row-in-block l] — exactly the row-major flatten of the TRANSPOSED
    (8, 16·npair) block-row slab — so the device-side pack is one minor-dim
    swapaxes plus pure reshapes. The measured alternative (a 6-D
    pack transpose at 8-granularity) cost 3.6x more than the whole matmul.
    With kk = 8h+k (h = block-of-pair), rows 64h+k*8+l land in the h-th
    diagonal block: W[64h + k*8+l, 64h + i*8+j] = T[i,k]*T[j,l].

    Accuracy: the pixel operand (level-shifted u8, ints in [-128,127]) is
    EXACT in bf16, so only the operator needs splitting — three terms give
    ~24 operator mantissa bits, keeping worst-case coefficient error far
    inside the ±1 oracle contract (tests/test_native.py:276)."""
    import ml_dtypes
    u = np.arange(8, dtype=np.float64)
    s = np.where(u == 0, np.sqrt(1.0 / 8.0), np.sqrt(2.0 / 8.0))
    t = s[:, None] * np.cos((2.0 * u[None, :] + 1.0) * u[:, None] * np.pi / 16.0)
    wh = np.einsum("ik,jl->klij", t, t).reshape(64, 64)
    w = np.zeros((128, 128), dtype=np.float64)
    w[:64, :64] = wh
    w[64:, 64:] = wh
    w0 = w.astype(ml_dtypes.bfloat16)
    w1 = (w - w0.astype(np.float64)).astype(ml_dtypes.bfloat16)
    w2 = (w - w0.astype(np.float64) - w1.astype(np.float64)).astype(
        ml_dtypes.bfloat16)
    return w0, w1, w2


def jpeg_dct_planes(planes_u8):
    """u8 image planes (c, rows, cols) → quantized q100 JPEG DCT blocks
    (c, ceil(rows/8), ceil(cols/8), 8, 8) int16 — the JPEG front-end (level
    shift, 8x8 FDCT, q100 quantize), so the host encoder pays entropy
    coding only. Per-block layout is the TRANSPOSED coefficient matrix,
    matching the native encoder's fdct8x8 (native/jpegenc.cpp) and its
    zigzag table.

    Implementation: each 8-row block-row slab transposes to (width, 8) —
    one minor-dim swapaxes — whose row-major flatten IS the pair-of-blocks
    128-vector sequence for the row-permuted operator (_dct_pair_split),
    and one (...,128)x(128,128) block-diagonal matmul applies the whole
    2D FDCT as three single-pass bf16 matrix products (split operator,
    exact pixel operand) in place of two K=8 f32 HIGHEST einsums."""
    c, rows, cols = planes_u8.shape
    nbh, nbw = -(-rows // 8), -(-cols // 8)
    npair = -(-nbw // 2)
    rh, rw = nbh * 8, npair * 16
    x = planes_u8
    if (rh, rw) != (rows, cols):
        # the host encoder edge-replicates partial border blocks; the
        # extra pad block of an odd-width pair is sliced off below
        x = jnp.pad(x, ((0, 0), (0, rh - rows), (0, rw - cols)), mode="edge")
    # level-shifted u8 is ints in [-128,127]: exact in bf16
    xb = (x.astype(jnp.bfloat16) - 128.0).reshape(c, nbh, 8, rw)
    v = jnp.swapaxes(xb, -1, -2).reshape(c, nbh, npair, 128)
    out = functools.reduce(jnp.add, (
        jnp.dot(v, jnp.asarray(w), preferred_element_type=jnp.float32)
        for w in _dct_pair_split()))
    out = out.reshape(c, nbh, npair * 2, 8, 8)[:, :, :nbw]
    # q100: all-ones quantizers — just round (ties-to-even like lrintf)
    return jnp.clip(jnp.round(out), -32767.0, 32767.0).astype(jnp.int16)


def _synrgb_combine(b1, b2, strategy, suppressed, channel_order: str,
                    row_axis=None, row_shards: int = 1):
    """Dual-band u8 → composed synRGB in the writer's channel order."""
    if suppressed is None:
        suppressed = strategy in (AutoscaleStrategy.TAMED, AutoscaleStrategy.CLAHE)
    out = (_synrgb_suppressed(b1, b2, row_axis, row_shards) if suppressed
           else _synrgb_default(b1, b2))
    if channel_order == "bgr":
        # free interleave reverse in-graph: the cv2 JPEG writer consumes it
        # without a host swap
        return out[..., ::-1]
    if channel_order in ("ycbcr", "dct"):
        planes = ycbcr_planes(out)
        if channel_order == "dct":
            # JPEG front-end on device: emit quantized DCT coefficient
            # blocks; the host runs the entropy-only encoder entry
            return jpeg_dct_planes(planes)
        return planes
    return out


def ycbcr_planes(rgb_u8):
    """Interleaved RGB u8 → planar full-range JFIF YCbCr u8 for the native
    JPEG encoder — the color conversion fuses into the program (free on
    device), so the host encoder pays neither color convert nor
    deinterleave."""
    r = rgb_u8[..., 0].astype(jnp.float32)
    g = rgb_u8[..., 1].astype(jnp.float32)
    b = rgb_u8[..., 2].astype(jnp.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    planes = jnp.stack([y, cb, cr])
    return jnp.clip(jnp.round(planes), 0.0, 255.0).astype(jnp.uint8)


# jitted per-stage entry points for the overlapped file path: band 1's
# program runs on device while band 2 is still streaming off disk, then the
# second program consumes the resident b1 — identical math to the single
# synrgb_pipeline program cut at the (exact, u8) band boundary
synrgb_band_stage = functools.partial(jax.jit, static_argnames=(
    "strategy", "copol", "target_size", "pad", "resample_alg", "row_axis",
    "row_shards"))(_synrgb_band)
synrgb_combine_stage = functools.partial(jax.jit, static_argnames=(
    "strategy", "suppressed", "channel_order", "row_axis", "row_shards"))(
        _synrgb_combine)


@functools.partial(
    jax.jit,
    static_argnames=("strategy", "bit_depth", "target_size", "pad",
                     "resample_alg", "row_axis", "row_shards", "jpeg_dct"),
)
def grayscale_pipeline(
    dn,
    strategy: AutoscaleStrategy = AutoscaleStrategy.STANDARD,
    bit_depth: BitDepth = BitDepth.U8,
    target_size: int | None = None,
    pad: bool = False,
    resample_alg: str | None = None,
    row_axis: str | None = None,
    row_shards: int = 1,
    jpeg_dct: bool = False,
):
    """Fused single-band program: DN raster → u8/u16 grayscale.

    `jpeg_dct` (U8 only) appends the in-graph JPEG front-end and returns
    quantized q100 coefficient blocks (bh, bw, 8, 8) int16 for the
    entropy-only host encoder (writers/jpeg.py write_gray_jpeg_dct)."""
    in_rows, in_cols = dn.shape
    if row_axis is not None:
        assert target_size is None and not pad, \
            "row-sharded mode processes full-res unpadded rasters"
        rows, cols, filt = in_rows, in_cols, None
    else:
        rows, cols, filt = _plan_read_dims(in_rows, in_cols, target_size,
                                           resample_alg)
    x = _resample_dn(dn, rows, cols, filt) if filt is not None else dn.astype(jnp.float32)
    db, mask = _db_mask(x)
    s = _stats(db, mask, row_axis)
    low, high, gamma = _window(s, strategy)
    max_val = jnp.float32(bit_depth.max_val)
    if strategy is AutoscaleStrategy.CLAHE:
        q16 = _clahe(db, mask, low, high, max_val, rows, cols,
                     row_axis, row_shards)
    else:
        q16 = _quantize(db, mask, low, high, gamma, max_val)
    out = _scale_u16_to_u8(q16, row_axis) if bit_depth is BitDepth.U8 else q16
    if pad:
        out = _pad_square(out, rows, cols)
    if jpeg_dct:
        assert bit_depth is BitDepth.U8, "JPEG front-end is u8-only"
        return jpeg_dct_planes(out[None])[0]
    return out
