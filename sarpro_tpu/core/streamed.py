"""Streamed big-scene pipelines: full-resolution rasters beyond the
single-program device-memory budget (the SURVEY §5 "long-context analogue").

The fused single-program path (fused.py) materializes several f32
intermediates of the whole raster, so its device memory grows with the
scene; past BIG_SCENE_PIXELS per band the fast path routes here instead.
This module keeps the SAME semantic definition but runs it as chunked
multi-pass streaming:

  pass A  per row-chunk: count / min / max            (accumulated exactly)
  pass B  per row-chunk: 4096-bin histogram + moments (global bins from A)
  [CLAHE] per row-chunk: tile histograms with global row offsets; then one
          tiny CDF program (fused._clahe_cdfs — identical math)
  pass C  per row-chunk: window/CLAHE apply → q16, written into a DONATED
          device buffer via dynamic_update_slice (no reallocation)
  pass D  per row-chunk: u16 → u8 double normalization with the GLOBAL
          q16 min/max
  synRGB  combined-histogram floor accumulated per chunk; suppressed LUTs
          built once (fused._suppressed_luts); per-chunk LUT composition

Each pass runs as ONE device program: a `lax.fori_loop` over the full
chunks plus an inlined ragged tail (the kernels take row offsets as
runtime scalars precisely so every iteration shares one compiled body), so
a band costs one dispatch and at most one host fetch.

Integer accumulations (histograms, counts) are exact, min/max combine
exactly, every per-pixel op runs the same kernels with a global
`row_offset`, and Adaptive's mean/std are derived from the integer
histogram (fused._stats_finalize) — so ALL strategy outputs, Adaptive
included, are BIT-IDENTICAL to the fused program (tested).

Device memory: inputs + one q16 staging buffer per band + output.
"""
from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger("sarpro")

from ..types import AutoscaleStrategy, BitDepth
from .clahe import CLAHE_BINS, TILES_X, TILES_Y
from .numerics import round_half_up_nonneg
from .pipeline import NUM_BINS
from . import fused

# Rows per scanned chunk (not tuned on the GPU; 82 M px at 20000 columns).
CHUNK_ROWS = 4096
# Above this many pixels per band the fast path routes through this module.
# Measured on an NVIDIA H100 80GB (700 W): the fused dual-pol CLAHE synRGB
# program at 20000² per band needs 27.6 GB (memory_analysis: 23.6 GB temp
# + 1.6 GB arguments + 2.4 GB output), i.e. 69 bytes per band pixel, while
# this streamed path ran the same 400 MP/band scene within an 11.5 GB
# process peak. At this threshold the fused program needs ~13.9 GB, under a
# quarter of JAX's default 60 GB pool on that card, so memory does not set
# it there; it stays where it was until fused and streamed are timed on
# either side of it.
BIG_SCENE_PIXELS = 192 << 20

# int32 device accumulation is exact while every accumulated count is
# bounded by the band's pixel count; past this the host-int64 paths engage
_DEVICE_ACC_MAX_PIXELS = 2**31 - 1


def _chunk_starts(rows: int, chunk: int):
    return [(r0, min(chunk, rows - r0)) for r0 in range(0, rows, chunk)]


def _plan(rows: int, chunk: int):
    """(full-chunk count, tail rows) for the scanned passes."""
    return rows // chunk, rows % chunk


# ---------------------------------------------------------------------------
# Per-chunk bodies (traced code shared by the scanned single-dispatch passes
# and the per-chunk host-accumulation fallbacks)
# ---------------------------------------------------------------------------
def _minmax_chunk(dn, r0, n: int):
    db, mask = fused._db_mask(jax.lax.dynamic_slice_in_dim(dn, r0, n, 0))
    count = jnp.sum(mask, dtype=jnp.int32)  # chunk < 2^31 px (validated)
    big = jnp.float32(np.inf)
    mn = jnp.min(jnp.where(mask, db, big))
    mx = jnp.max(jnp.where(mask, db, -big))
    return count, mn, mx


def _hist_chunk(dn, mn, mx, r0, n: int):
    from ..ops import histogram

    db, mask = fused._db_mask(jax.lax.dynamic_slice_in_dim(dn, r0, n, 0))
    return histogram(fused._db_bin_index(db, mask, mn, mx), NUM_BINS)


def _tile_hist_chunk(dn, low, high, r0, n: int, cols: int,
                     tile_h: int, tile_w: int, row_base=0):
    """`r0` slices the LOCAL raster; `r0 + row_base` is the GLOBAL row
    offset into the CLAHE tile geometry (row_base != 0 only under the
    row-sharded mesh path, where `dn` is one shard's block)."""
    from ..ops import tile_histogram

    db, mask = fused._db_mask(jax.lax.dynamic_slice_in_dim(dn, r0, n, 0))
    norm = fused._clahe_norm(db, mask, low, high)
    bin_m = fused._clahe_bins(norm, mask, n, cols, tile_h, tile_w,
                              row_offset=r0 + row_base)
    return tile_histogram(bin_m.ravel(), cols, TILES_X, TILES_Y, tile_h,
                          tile_w, row_offset=r0 + row_base, n_bins=CLAHE_BINS)


def _tile_hist_stage_chunk(bin_buf, dn, low, high, r0, n: int, cols: int,
                           tile_h: int, tile_w: int, row_base=0):
    """Tile-hist pass that ALSO stages the per-pixel CLAHE bins into the
    u16 staging buffer (CLAHE_BINS = the invalid marker): the apply pass
    reads them back instead of recomputing dB/norm/bins over the DN —
    saving one full transcendental+binning traversal per band.
    The staged values are exactly what the apply would recompute
    (same f32 expressions), so outputs stay byte-identical."""
    from ..ops import tile_histogram

    db, mask = fused._db_mask(jax.lax.dynamic_slice_in_dim(dn, r0, n, 0))
    norm = fused._clahe_norm(db, mask, low, high)
    bin_m = fused._clahe_bins(norm, mask, n, cols, tile_h, tile_w,
                              row_offset=r0 + row_base)
    hist = tile_histogram(bin_m.ravel(), cols, TILES_X, TILES_Y, tile_h,
                          tile_w, row_offset=r0 + row_base,
                          n_bins=CLAHE_BINS)
    buf = jax.lax.dynamic_update_slice_in_dim(
        bin_buf, bin_m.astype(jnp.uint16), r0, 0)
    return buf, hist


def _apply_clahe_bins_chunk(q16_buf, max_val, cdfs, r0, n: int, cols: int,
                            tile_h: int, tile_w: int, row_base=0):
    """CLAHE apply from the staged bins: reads the bin chunk from the SAME
    buffer it overwrites with q16 (read-then-write per chunk; the scan
    threads the buffer functionally so XLA aliases it in place)."""
    from ..ops import clahe_lookup

    bin_m = jax.lax.dynamic_slice_in_dim(q16_buf, r0, n, 0).astype(jnp.int32)
    mask = bin_m < CLAHE_BINS
    eq = clahe_lookup(bin_m.ravel(), cdfs, cols, TILES_X, TILES_Y, tile_h,
                      tile_w, row_offset=r0 + row_base).reshape(n, cols)
    q = jnp.trunc(jnp.clip(eq, 0.0, 1.0) * max_val)
    q16 = jnp.where(mask, q, 0.0).astype(jnp.uint16)
    return (jax.lax.dynamic_update_slice_in_dim(q16_buf, q16, r0, 0),
            jnp.min(q16), jnp.max(q16))


def _apply_clahe_chunk(q16_buf, dn, low, high, max_val, cdfs, r0, n: int,
                       cols: int, tile_h: int, tile_w: int, row_base=0):
    from ..ops import clahe_lookup

    db, mask = fused._db_mask(jax.lax.dynamic_slice_in_dim(dn, r0, n, 0))
    norm = fused._clahe_norm(db, mask, low, high)
    bin_flat = fused._clahe_bins(norm, mask, n, cols, tile_h, tile_w,
                                 row_offset=r0 + row_base).ravel()
    eq = clahe_lookup(bin_flat, cdfs, cols, TILES_X, TILES_Y, tile_h,
                      tile_w, row_offset=r0 + row_base).reshape(n, cols)
    q = jnp.trunc(jnp.clip(eq, 0.0, 1.0) * max_val)
    q16 = jnp.where(mask, q, 0.0).astype(jnp.uint16)
    return (jax.lax.dynamic_update_slice_in_dim(q16_buf, q16, r0, 0),
            jnp.min(q16), jnp.max(q16))


def _apply_window_chunk(q16_buf, dn, low, high, gamma, max_val, r0, n: int):
    db, mask = fused._db_mask(jax.lax.dynamic_slice_in_dim(dn, r0, n, 0))
    q16 = fused._quantize(db, mask, low, high, gamma, max_val)
    return (jax.lax.dynamic_update_slice_in_dim(q16_buf, q16, r0, 0),
            jnp.min(q16), jnp.max(q16))


def _apply_tamed_chunk(q16_buf, dn, low, high, r0, n: int):
    """Band-specific tamed window straight to u8 range (autoscale.rs:710-742),
    staged in the u16 buffer."""
    db, mask = fused._db_mask(jax.lax.dynamic_slice_in_dim(dn, r0, n, 0))
    q16 = fused._tamed_quantize_u8(db, mask, low, high).astype(jnp.uint16)
    return jax.lax.dynamic_update_slice_in_dim(q16_buf, q16, r0, 0)


def _q16_u8_vals(q, mn, mx):
    """u8 codes of the global u16→u8 double normalization — the ONE
    arithmetic shared by the scale pass, the hist-only pass, and the
    q16-composing chunks, so every route rounds identically (fused
    ._scale_u16_to_u8 / autoscale.rs:348-364). For TAMED bands (already
    u8-valued) callers pass mn=0, mx=255: scale is exactly 1 and the map
    is the identity."""
    mn = mn.astype(jnp.float32)
    mx = mx.astype(jnp.float32)
    scale = jnp.where(mx > mn, 255.0 / (mx - mn), 1.0)
    val = round_half_up_nonneg((q.astype(jnp.float32) - mn) * scale)
    return jnp.clip(val, 0.0, 255.0).astype(jnp.uint8)


def _scale_u8_chunk(u8_buf, q16_buf, mn, mx, r0, n: int, with_hist: bool):
    """u16 → u8 double normalization of one chunk; with `with_hist`, also
    the chunk's u8 histogram (accumulated by the suppressed-synRGB floor —
    riding this pass saves a device pass over the output)."""
    from ..ops import histogram

    q = jax.lax.dynamic_slice_in_dim(q16_buf, r0, n, 0)
    u8 = _q16_u8_vals(q, mn, mx)
    hist = (histogram(u8, 256) if with_hist
            else jnp.zeros((256,), jnp.int32))
    return jax.lax.dynamic_update_slice_in_dim(u8_buf, u8, r0, 0), hist


def _u8hist_q16_chunk(q16_buf, mn, mx, r0, n: int):
    """Histogram of the u8 codes WITHOUT materializing a u8 buffer — the
    q16-composing synRGB route needs only the combined histogram (for the
    suppressed floor) before composing straight from q16."""
    from ..ops import histogram

    q = jax.lax.dynamic_slice_in_dim(q16_buf, r0, n, 0)
    return histogram(_q16_u8_vals(q, mn, mx), 256)


def _u8_hist_chunk(b, r0, n: int):
    from ..ops import histogram

    return histogram(jax.lax.dynamic_slice_in_dim(b, r0, n, 0), 256)


def _compose_suppressed_chunk(rgb_buf, b1, b2, floor_c, lut_r, lut_g, lut_b,
                              r0, n: int):
    from ..ops import synrgb_lookup

    c1 = jax.lax.dynamic_slice_in_dim(b1, r0, n, 0)
    c2 = jax.lax.dynamic_slice_in_dim(b2, r0, n, 0)
    i1 = c1.astype(jnp.int32)
    i2 = c2.astype(jnp.int32)
    rgb = synrgb_lookup(i1.ravel(), i2.ravel(), lut_r, lut_g,
                        lut_b).reshape(c1.shape + (3,))
    water = ((i1.astype(jnp.float32) <= floor_c)
             & (i2.astype(jnp.float32) <= floor_c))[..., None]
    rgb = jnp.where(water, jnp.uint8(0), rgb)
    return jax.lax.dynamic_update_slice_in_dim(rgb_buf, rgb, r0, 0)


def _compose_default_chunk(rgb_buf, b1, b2, r0, n: int):
    c1 = jax.lax.dynamic_slice_in_dim(b1, r0, n, 0)
    c2 = jax.lax.dynamic_slice_in_dim(b2, r0, n, 0)
    rgb = fused._synrgb_default(c1, c2)
    return jax.lax.dynamic_update_slice_in_dim(rgb_buf, rgb, r0, 0)


# --- q16-composing variants: the bands stay in their q16 staging buffers
# and the u16→u8 scale folds INTO the compose — the
# separate scale pass shrinks to a hist-only fold and no u8 planes are
# ever materialized. u8 codes come from _q16_u8_vals (identical rounding),
# and padded q16 zeros map to u8 0 exactly like the padded-u8 route
# ((0-mn)·scale ≤ 0 clips to 0), so outputs are byte-identical.
def _q16_chunk_codes(q1, q2, mn1, mx1, mn2, mx2, r0, n: int):
    c1 = _q16_u8_vals(jax.lax.dynamic_slice_in_dim(q1, r0, n, 0), mn1, mx1)
    c2 = _q16_u8_vals(jax.lax.dynamic_slice_in_dim(q2, r0, n, 0), mn2, mx2)
    return c1, c2


def _compose_suppressed_q16_chunk(rgb_buf, q1, q2, mn1, mx1, mn2, mx2,
                                  floor_c, lut_r, lut_g, lut_b, r0, n: int):
    from ..ops import synrgb_lookup

    c1, c2 = _q16_chunk_codes(q1, q2, mn1, mx1, mn2, mx2, r0, n)
    i1 = c1.astype(jnp.int32)
    i2 = c2.astype(jnp.int32)
    rgb = synrgb_lookup(i1.ravel(), i2.ravel(), lut_r, lut_g,
                        lut_b).reshape(c1.shape + (3,))
    water = ((i1.astype(jnp.float32) <= floor_c)
             & (i2.astype(jnp.float32) <= floor_c))[..., None]
    rgb = jnp.where(water, jnp.uint8(0), rgb)
    return jax.lax.dynamic_update_slice_in_dim(rgb_buf, rgb, r0, 0)


def _compose_default_q16_chunk(rgb_buf, q1, q2, mn1, mx1, mn2, mx2, r0,
                               n: int):
    c1, c2 = _q16_chunk_codes(q1, q2, mn1, mx1, mn2, mx2, r0, n)
    rgb = fused._synrgb_default(c1, c2)
    return jax.lax.dynamic_update_slice_in_dim(rgb_buf, rgb, r0, 0)


# ---------------------------------------------------------------------------
# Per-chunk jits: the >int32-pixels host-accumulation fallbacks dispatch one
# program per chunk and fetch each result (exact int64 totals on the host)
# ---------------------------------------------------------------------------
_pass_minmax = functools.partial(jax.jit, static_argnames=("n",))(
    _minmax_chunk)
_pass_hist = functools.partial(jax.jit, static_argnames=("n",))(_hist_chunk)
_pass_tile_hist = functools.partial(
    jax.jit, static_argnames=("n", "tile_h", "tile_w", "cols"))(
    _tile_hist_chunk)
_pass_apply_clahe = functools.partial(
    jax.jit, donate_argnums=(0,),
    static_argnames=("n", "cols", "tile_h", "tile_w"))(_apply_clahe_chunk)
_pass_apply_window = functools.partial(
    jax.jit, donate_argnums=(0,), static_argnames=("n",))(
    _apply_window_chunk)
_pass_apply_tamed = functools.partial(
    jax.jit, donate_argnums=(0,), static_argnames=("n",))(_apply_tamed_chunk)
_pass_scale_u8 = functools.partial(
    jax.jit, donate_argnums=(0,), static_argnames=("n", "with_hist"))(
    _scale_u8_chunk)
_pass_u8_hist = functools.partial(jax.jit, static_argnames=("n",))(
    _u8_hist_chunk)
_pass_compose_suppressed = functools.partial(
    jax.jit, donate_argnums=(0,), static_argnames=("n",))(
    _compose_suppressed_chunk)
_pass_compose_default = functools.partial(
    jax.jit, donate_argnums=(0,), static_argnames=("n",))(
    _compose_default_chunk)


@functools.partial(jax.jit, static_argnames=("n",))
def _pass_dct_chunk(img, r0, n: int):
    """JPEG front-end over rows [r0, r0+n) of a composed u8 image: RGB
    interleaved (rows, cols, 3) → (3, n/8↑, cols/8↑, 8, 8) int16, or a
    single gray plane (rows, cols) → (1, ...). Chunk boundaries must be
    8-aligned (the caller guarantees it) so only the true image bottom
    edge-replicates."""
    if img.ndim == 3:
        chunk = jax.lax.dynamic_slice(
            img, (r0, 0, 0), (n, img.shape[1], 3))
        return fused.jpeg_dct_planes(fused.ycbcr_planes(chunk))
    chunk = jax.lax.dynamic_slice_in_dim(img, r0, n, 0)
    return fused.jpeg_dct_planes(chunk[None])


def dct_blocks_streamed(img, chunk_rows: int = CHUNK_ROWS) -> np.ndarray:
    """Chunked device JPEG front-end over a composed full-res u8 image
    (device-resident RGB interleaved or gray 2-D): returns the host
    coefficient array for the entropy-only encoder — (3|1, BH, BW, 8, 8)
    int16 — without materializing full-image f32 planes on the device.

    Dispatch runs a BOUNDED window ahead of the fetches: the d2h of chunk
    k overlaps the compute of chunks k+1/k+2 without keeping every chunk's
    int16 coefficient output alive on the device at once — unbounded
    fan-out would hold the whole coefficient array (~6 B/px for RGB) next
    to the u8 input and run out of memory on the very scenes this module
    exists for."""
    rows = img.shape[0]
    step = max(chunk_rows // 8 * 8, 8)  # 8-aligned interior boundaries
    ahead = 2
    starts = _chunk_starts(rows, step)
    pending = [_pass_dct_chunk(img, r0, n) for r0, n in starts[:ahead + 1]]
    parts = []
    for i in range(len(starts)):
        if i + ahead + 1 < len(starts):
            r0, n = starts[i + ahead + 1]
            pending.append(_pass_dct_chunk(img, r0, n))
        parts.append(np.asarray(pending[i]))
        pending[i] = None  # release the device buffer
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)


# ---------------------------------------------------------------------------
# Scanned passes: ONE device program per pass — lax.fori_loop over the full
# chunks (row offset i·chunk is a traced scalar into the shared body) with
# the ragged tail inlined after the loop. Accumulation order matches the
# host folds exactly (chunks in order, tail last), so results are
# bit-identical to the per-chunk path.
# ---------------------------------------------------------------------------
def _scan_minmax_raw(dn, chunk: int, k: int, tail: int):
    """Fold WITHOUT the empty-band normalization: the row-sharded path must
    combine the raw ±inf accumulators across shards first (a locally-empty
    shard would otherwise clamp its min to 0 and poison the global pmin)."""
    init = (jnp.int32(0), jnp.float32(np.inf), jnp.float32(-np.inf))

    def body(i, acc):
        c, a, b = _minmax_chunk(dn, i * chunk, chunk)
        return acc[0] + c, jnp.minimum(acc[1], a), jnp.maximum(acc[2], b)

    count, mn, mx = jax.lax.fori_loop(0, k, body, init)
    if tail:
        c, a, b = _minmax_chunk(dn, k * chunk, tail)
        count, mn, mx = count + c, jnp.minimum(mn, a), jnp.maximum(mx, b)
    return count, mn, mx


def _minmax_normalize(count, mn, mx):
    """Empty-band normalization (same as the host fold)."""
    mn = jnp.where(count == 0, jnp.float32(0.0), mn)
    mx = jnp.where(count == 0, jnp.float32(0.0), mx)
    return mn, mx


def _scan_minmax_impl(dn, chunk: int, k: int, tail: int):
    count, mn, mx = _scan_minmax_raw(dn, chunk, k, tail)
    mn, mx = _minmax_normalize(count, mn, mx)
    return count, mn, mx


_scan_minmax = functools.partial(
    jax.jit, static_argnames=("chunk", "k", "tail"))(_scan_minmax_impl)


def _scan_stats_raw(dn, mn, mx, chunk: int, k: int, tail: int):
    """Histogram fold over all chunks (pre-finalize: the row-sharded path
    psums it across shards before the shared finalize). Moments are derived
    from the histogram in fused._stats_finalize — integer bin adds commute
    exactly, so the chunked fold is byte-identical to the fused program for
    every strategy including Adaptive."""
    init = jnp.zeros((NUM_BINS,), jnp.int32)

    def body(i, acc):
        return acc + _hist_chunk(dn, mn, mx, i * chunk, chunk)

    hist = jax.lax.fori_loop(0, k, body, init)
    if tail:
        hist = hist + _hist_chunk(dn, mn, mx, k * chunk, tail)
    return hist


def _scan_stats_impl(dn, count, mn, mx, chunk: int, k: int, tail: int):
    """Histogram over all chunks, finalized to the percentile dict in the
    same program (fused._stats_finalize)."""
    hist = _scan_stats_raw(dn, mn, mx, chunk, k, tail)
    return fused._stats_finalize(hist, count, mn, mx)


_scan_stats = functools.partial(
    jax.jit, static_argnames=("chunk", "k", "tail"))(_scan_stats_impl)


def _scan_tile_hist_impl(dn, low, high, chunk: int, k: int, tail: int,
                         cols: int, tile_h: int, tile_w: int, row_base=0):
    init = jnp.zeros((TILES_Y * TILES_X * CLAHE_BINS,), jnp.int32)

    def body(i, acc):
        return acc + _tile_hist_chunk(dn, low, high, i * chunk, chunk, cols,
                                      tile_h, tile_w, row_base)

    hists = jax.lax.fori_loop(0, k, body, init)
    if tail:
        hists = hists + _tile_hist_chunk(dn, low, high, k * chunk, tail,
                                         cols, tile_h, tile_w, row_base)
    return hists


_scan_tile_hist = functools.partial(
    jax.jit, static_argnames=("chunk", "k", "tail", "cols",
                              "tile_h", "tile_w"))(_scan_tile_hist_impl)


def _scan_tile_hist_stage_impl(bin_buf, dn, low, high, chunk: int, k: int,
                               tail: int, cols: int, tile_h: int,
                               tile_w: int, row_base=0):
    init = (bin_buf, jnp.zeros((TILES_Y * TILES_X * CLAHE_BINS,), jnp.int32))

    def body(i, acc):
        buf, h = _tile_hist_stage_chunk(acc[0], dn, low, high, i * chunk,
                                        chunk, cols, tile_h, tile_w,
                                        row_base)
        return buf, acc[1] + h

    buf, hists = jax.lax.fori_loop(0, k, body, init)
    if tail:
        buf, h = _tile_hist_stage_chunk(buf, dn, low, high, k * chunk, tail,
                                        cols, tile_h, tile_w, row_base)
        hists = hists + h
    return buf, hists


def _scan_apply_clahe_bins_impl(q16_buf, max_val, cdfs, chunk: int, k: int,
                                tail: int, cols: int, tile_h: int,
                                tile_w: int, row_base=0):
    init = (q16_buf, jnp.uint16(65535), jnp.uint16(0))

    def body(i, acc):
        buf, a, b = _apply_clahe_bins_chunk(acc[0], max_val, cdfs,
                                            i * chunk, chunk, cols, tile_h,
                                            tile_w, row_base)
        return buf, jnp.minimum(acc[1], a), jnp.maximum(acc[2], b)

    buf, mn, mx = jax.lax.fori_loop(0, k, body, init)
    if tail:
        buf, a, b = _apply_clahe_bins_chunk(buf, max_val, cdfs, k * chunk,
                                            tail, cols, tile_h, tile_w,
                                            row_base)
        mn, mx = jnp.minimum(mn, a), jnp.maximum(mx, b)
    return buf, mn, mx


def _scan_u8hist_q16_impl(q16_buf, mn, mx, chunk: int, k: int, tail: int):
    def body(i, acc):
        return acc + _u8hist_q16_chunk(q16_buf, mn, mx, i * chunk, chunk)

    hist = jax.lax.fori_loop(0, k, body, jnp.zeros((256,), jnp.int32))
    if tail:
        hist = hist + _u8hist_q16_chunk(q16_buf, mn, mx, k * chunk, tail)
    return hist


def _scan_apply_clahe_impl(q16_buf, dn, low, high, max_val, cdfs, chunk: int,
                           k: int, tail: int, cols: int, tile_h: int,
                           tile_w: int, row_base=0):
    init = (q16_buf, jnp.uint16(65535), jnp.uint16(0))

    def body(i, acc):
        buf, a, b = _apply_clahe_chunk(acc[0], dn, low, high, max_val, cdfs,
                                       i * chunk, chunk, cols, tile_h,
                                       tile_w, row_base)
        return buf, jnp.minimum(acc[1], a), jnp.maximum(acc[2], b)

    buf, mn, mx = jax.lax.fori_loop(0, k, body, init)
    if tail:
        buf, a, b = _apply_clahe_chunk(buf, dn, low, high, max_val, cdfs,
                                       k * chunk, tail, cols, tile_h,
                                       tile_w, row_base)
        mn, mx = jnp.minimum(mn, a), jnp.maximum(mx, b)
    return buf, mn, mx


_scan_apply_clahe = functools.partial(
    jax.jit, donate_argnums=(0,),
    static_argnames=("chunk", "k", "tail", "cols",
                     "tile_h", "tile_w"))(_scan_apply_clahe_impl)


def _scan_apply_window_impl(q16_buf, dn, low, high, gamma, max_val,
                            chunk: int, k: int, tail: int):
    init = (q16_buf, jnp.uint16(65535), jnp.uint16(0))

    def body(i, acc):
        buf, a, b = _apply_window_chunk(acc[0], dn, low, high, gamma,
                                        max_val, i * chunk, chunk)
        return buf, jnp.minimum(acc[1], a), jnp.maximum(acc[2], b)

    buf, mn, mx = jax.lax.fori_loop(0, k, body, init)
    if tail:
        buf, a, b = _apply_window_chunk(buf, dn, low, high, gamma, max_val,
                                        k * chunk, tail)
        mn, mx = jnp.minimum(mn, a), jnp.maximum(mx, b)
    return buf, mn, mx


_scan_apply_window = functools.partial(
    jax.jit, donate_argnums=(0,),
    static_argnames=("chunk", "k", "tail"))(_scan_apply_window_impl)


def _scan_apply_tamed_impl(q16_buf, dn, low, high, chunk: int, k: int,
                           tail: int):
    def body(i, buf):
        return _apply_tamed_chunk(buf, dn, low, high, i * chunk, chunk)

    buf = jax.lax.fori_loop(0, k, body, q16_buf)
    if tail:
        buf = _apply_tamed_chunk(buf, dn, low, high, k * chunk, tail)
    return buf


_scan_apply_tamed = functools.partial(
    jax.jit, donate_argnums=(0,),
    static_argnames=("chunk", "k", "tail"))(_scan_apply_tamed_impl)


def _scan_scale_u8_impl(u8_buf, q16_buf, mn, mx, chunk: int, k: int,
                        tail: int, with_hist: bool):
    init = (u8_buf, jnp.zeros((256,), jnp.int32))

    def body(i, acc):
        buf, h = _scale_u8_chunk(acc[0], q16_buf, mn, mx, i * chunk, chunk,
                                 with_hist)
        return buf, acc[1] + h

    buf, hist = jax.lax.fori_loop(0, k, body, init)
    if tail:
        buf, h = _scale_u8_chunk(buf, q16_buf, mn, mx, k * chunk, tail,
                                 with_hist)
        hist = hist + h
    return buf, hist


_scan_scale_u8 = functools.partial(
    jax.jit, donate_argnums=(0,),
    static_argnames=("chunk", "k", "tail", "with_hist"))(_scan_scale_u8_impl)


def _scan_u8_hist_impl(b, chunk: int, k: int, tail: int):
    def body(i, acc):
        return acc + _u8_hist_chunk(b, i * chunk, chunk)

    hist = jax.lax.fori_loop(0, k, body, jnp.zeros((256,), jnp.int32))
    if tail:
        hist = hist + _u8_hist_chunk(b, k * chunk, tail)
    return hist


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("chunk", "k", "tail"))
def _scan_compose_suppressed(rgb_buf, b1, b2, floor_c, lut_r, lut_g, lut_b,
                             chunk: int, k: int, tail: int):
    def body(i, buf):
        return _compose_suppressed_chunk(buf, b1, b2, floor_c, lut_r, lut_g,
                                         lut_b, i * chunk, chunk)

    buf = jax.lax.fori_loop(0, k, body, rgb_buf)
    if tail:
        buf = _compose_suppressed_chunk(buf, b1, b2, floor_c, lut_r, lut_g,
                                        lut_b, k * chunk, tail)
    return buf


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("chunk", "k", "tail"))
def _scan_compose_default(rgb_buf, b1, b2, chunk: int, k: int, tail: int):
    def body(i, buf):
        return _compose_default_chunk(buf, b1, b2, i * chunk, chunk)

    buf = jax.lax.fori_loop(0, k, body, rgb_buf)
    if tail:
        buf = _compose_default_chunk(buf, b1, b2, k * chunk, tail)
    return buf


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("chunk", "k", "tail"))
def _scan_compose_suppressed_q16(rgb_buf, q1, q2, mn1, mx1, mn2, mx2,
                                 floor_c, lut_r, lut_g, lut_b, chunk: int,
                                 k: int, tail: int):
    def body(i, buf):
        return _compose_suppressed_q16_chunk(buf, q1, q2, mn1, mx1, mn2,
                                             mx2, floor_c, lut_r, lut_g,
                                             lut_b, i * chunk, chunk)

    buf = jax.lax.fori_loop(0, k, body, rgb_buf)
    if tail:
        buf = _compose_suppressed_q16_chunk(buf, q1, q2, mn1, mx1, mn2, mx2,
                                            floor_c, lut_r, lut_g, lut_b,
                                            k * chunk, tail)
    return buf


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("chunk", "k", "tail"))
def _scan_compose_default_q16(rgb_buf, q1, q2, mn1, mx1, mn2, mx2,
                              chunk: int, k: int, tail: int):
    def body(i, buf):
        return _compose_default_q16_chunk(buf, q1, q2, mn1, mx1, mn2, mx2,
                                          i * chunk, chunk)

    buf = jax.lax.fori_loop(0, k, body, rgb_buf)
    if tail:
        buf = _compose_default_q16_chunk(buf, q1, q2, mn1, mx1, mn2, mx2,
                                         k * chunk, tail)
    return buf


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("rows_global", "cols", "tile_h",
                                             "tile_w"))
def _cdfs_from_hists(hists, rows_global: int, cols: int, tile_h: int,
                     tile_w: int):
    return fused._clahe_cdfs(hists, rows_global, cols, tile_h, tile_w)


# ---------------------------------------------------------------------------
# Fused per-band program: the streamed path packs a band's ENTIRE chain —
# minmax → stats → finalize → window → (tile-hist → CDFs →) apply → u16→u8
# scale [+hist] — into ONE program: one dispatch plus at most one fetch per
# band, vs six dispatches as separate scans. Bit-identity with the separate scans
# is structural (the same loop bodies compose; XLA does not reassociate
# float reductions) and locked by tests/test_streamed.py.
#
# The SAME body serves the row-sharded mesh mode (`axis` set, run inside
# shard_map): the reduction points become collectives — psum for
# the integer histograms / counts / moments, pmin/pmax for the extrema —
# and the CLAHE chunk bodies take `row_base = axis_index · local_rows` so
# bin/tile assignment is identical to the unsharded scan. Integer
# reductions and min/max combine exactly, and Adaptive's mean/std come
# from the integer histogram, so EVERY strategy is BYTE-IDENTICAL across
# shard counts (tests/test_streamed_sharded.py).
# ---------------------------------------------------------------------------
def _band_body(dn_l, chunk: int, k: int, tail: int,
               strategy: AutoscaleStrategy, tamed_copol: bool | None,
               max_val: float, to_u8: bool, with_hist: bool, cols: int,
               tile_h: int, tile_w: int, rows_g: int, local: int,
               axis: str | None, emit_q16: bool = False):
    """With `emit_q16` (the synRGB compose-from-q16 route)
    the band returns `(q16, hist, mn, mx)` — the staging buffer plus the
    scale scalars — and NO u8 plane is materialized: the u16→u8 scale runs
    inline in the compose chunks (identical rounding via _q16_u8_vals) and
    the histogram folds without a buffer write. TAMED bands return their
    u8-valued buffer with (mn=0, mx=255), under which the scale map is
    exactly the identity."""
    count, mn, mx = _scan_minmax_raw(dn_l, chunk, k, tail)
    if axis is not None:
        count = jax.lax.psum(count, axis)
        mn = jax.lax.pmin(mn, axis)
        mx = jax.lax.pmax(mx, axis)
    mn, mx = _minmax_normalize(count, mn, mx)
    hist = _scan_stats_raw(dn_l, mn, mx, chunk, k, tail)
    if axis is not None:
        hist = jax.lax.psum(hist, axis)
    s = fused._stats_finalize(hist, count, mn, mx)

    if tamed_copol is not None and strategy is AutoscaleStrategy.TAMED:
        # band-specific tamed window (fused._band_u8 / autoscale.rs:710-742)
        low = (jnp.minimum(s["p02"], s["p05"]) if tamed_copol else s["p05"])
        high = s["p99"]
        q16 = jnp.zeros((local, cols), jnp.uint16)
        q16 = _scan_apply_tamed_impl(q16, dn_l, low, high, chunk, k, tail)
        if emit_q16:
            mn_j = jnp.int32(0)
            mx_j = jnp.int32(255)
            if with_hist:
                h = _scan_u8hist_q16_impl(q16, mn_j, mx_j, chunk, k, tail)
                if axis is not None:
                    h = jax.lax.psum(h, axis)
            else:
                h = jnp.zeros((256,), jnp.int32)
            return q16, h, mn_j, mx_j
        u8 = q16.astype(jnp.uint8)
        if not with_hist:
            return u8, jnp.zeros((256,), jnp.int32)
        h = _scan_u8_hist_impl(u8, chunk, k, tail)
        return u8, (jax.lax.psum(h, axis) if axis is not None else h)

    low, high, gamma = fused._window(s, strategy)
    mv = jnp.float32(max_val)
    q16 = jnp.zeros((local, cols), jnp.uint16)
    if strategy is AutoscaleStrategy.CLAHE:
        row_base = (jax.lax.axis_index(axis).astype(jnp.int32) * local
                    if axis is not None else 0)
        # the tile-hist pass stages its computed bins in the q16 buffer so
        # the apply pass reads them back instead of redoing dB/norm/bins
        q16, hists = _scan_tile_hist_stage_impl(
            q16, dn_l, low, high, chunk, k, tail, cols, tile_h, tile_w,
            row_base)
        if axis is not None:
            hists = jax.lax.psum(hists, axis)
        cdfs = fused._clahe_cdfs(hists, rows_g, cols, tile_h, tile_w)
        q16, mn_j, mx_j = _scan_apply_clahe_bins_impl(
            q16, mv, cdfs, chunk, k, tail, cols, tile_h, tile_w, row_base)
    else:
        q16, mn_j, mx_j = _scan_apply_window_impl(
            q16, dn_l, low, high, gamma, mv, chunk, k, tail)
    # q16 extrema combine exactly; int32 carries the u16 range losslessly
    # (uint16 is not a portable collective dtype on all backends; the scale
    # body converts to f32 either way)
    mn_j = mn_j.astype(jnp.int32)
    mx_j = mx_j.astype(jnp.int32)
    if axis is not None:
        mn_j = jax.lax.pmin(mn_j, axis)
        mx_j = jax.lax.pmax(mx_j, axis)
    if emit_q16:
        if with_hist:
            h = _scan_u8hist_q16_impl(q16, mn_j, mx_j, chunk, k, tail)
            if axis is not None:
                h = jax.lax.psum(h, axis)
        else:
            h = jnp.zeros((256,), jnp.int32)
        return q16, h, mn_j, mx_j
    if not to_u8:
        return q16, jnp.zeros((256,), jnp.int32)
    u8 = jnp.zeros((local, cols), jnp.uint8)
    u8, h = _scan_scale_u8_impl(u8, q16, mn_j, mx_j, chunk, k, tail,
                                with_hist)
    if with_hist and axis is not None:
        h = jax.lax.psum(h, axis)
    return u8, h


_scan_band_full = functools.partial(
    jax.jit,
    static_argnames=("chunk", "k", "tail", "strategy", "tamed_copol",
                     "max_val", "to_u8", "with_hist", "cols", "tile_h",
                     "tile_w", "rows_g", "local", "axis", "emit_q16"))(
    _band_body)


@functools.partial(
    jax.jit,
    static_argnames=("chunk", "k", "tail", "strategy", "tamed_copol",
                     "max_val", "to_u8", "with_hist", "cols", "tile_h",
                     "tile_w", "rows_g", "local", "mesh", "emit_q16"))
def _sharded_band_program(dn, chunk: int, k: int, tail: int,
                          strategy: AutoscaleStrategy,
                          tamed_copol: bool | None, max_val: float,
                          to_u8: bool, with_hist: bool, cols: int,
                          tile_h: int, tile_w: int, rows_g: int,
                          local: int, mesh, emit_q16: bool = False):
    """Row-sharded band program: _band_body under shard_map with the
    'row' mesh axis as its collective axis (SURVEY §2.5)."""
    from jax.sharding import PartitionSpec as P

    def per_device(dn_l):
        return _band_body(
            dn_l, chunk, k, tail, strategy, tamed_copol, max_val, to_u8,
            with_hist, cols, tile_h, tile_w, rows_g, local, "row",
            emit_q16)

    out_specs = ((P("row", None), P(), P(), P()) if emit_q16
                 else (P("row", None), P()))
    return jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P("row", None),),
        out_specs=out_specs,
        check_vma=False,
    )(dn)


def _band_u8_streamed_sharded(dn, strategy: AutoscaleStrategy,
                              tamed_copol: bool | None,
                              bit_depth: BitDepth, chunk_rows: int,
                              collect_hist: bool, mesh,
                              emit_q16: bool = False):
    """Row-sharded variant of the device-accumulation fast path: ONE
    shard_map program per band (stats+window+apply fused; collectives at
    the reduction points). Returns (out, hist) with `out` row-sharded on
    the mesh and `hist` a replicated device int32 array."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    rows, cols = dn.shape
    n = mesh.shape["row"]
    local = rows // n
    dn = jax.device_put(dn, NamedSharding(mesh, P("row", None)))
    chunk = max(min(chunk_rows, local, (2**31 - 1) // max(cols, 1)), 1)
    k, tail = _plan(local, chunk)
    # mirror the unsharded caller exactly: the program's to_u8 governs only
    # the non-tamed global u16->u8 rescale, but the hist flag must include
    # the tamed term (the TAMED path emits u8 internally and consults
    # with_hist directly in _band_body) — otherwise TAMED+U16+collect_hist
    # would return an all-zero histogram the caller treats as collected
    tamed = tamed_copol is not None and strategy is AutoscaleStrategy.TAMED
    to_u8 = bit_depth is not BitDepth.U16
    tile_h = -(-rows // TILES_Y)
    tile_w = -(-cols // TILES_X)
    return _sharded_band_program(
        dn, chunk, k, tail, strategy, tamed_copol,
        float(bit_depth.max_val), to_u8,
        collect_hist and (tamed or to_u8), cols,
        tile_h, tile_w, rows, local, mesh, emit_q16)


def _band_stats_hostacc(dn, chunks):
    count = np.int64(0)
    mn = np.float32(np.inf)
    mx = np.float32(-np.inf)
    for r0, n in chunks:
        c, a, b = _pass_minmax(dn, r0, n)
        count += np.int64(np.asarray(c))
        mn = np.minimum(mn, np.asarray(a))
        mx = np.maximum(mx, np.asarray(b))
    if count == 0:
        mn = np.float32(0.0)
        mx = np.float32(0.0)
    mn_j = jnp.asarray(mn)
    mx_j = jnp.asarray(mx)
    hist = np.zeros(NUM_BINS, np.int64)
    for r0, n in chunks:
        hist += np.asarray(_pass_hist(dn, mn_j, mx_j, r0, n), np.int64)
    if count > np.iinfo(np.int32).max:
        # >2.1 Gpx valid pixels: the device finalize's int32 count/cumsum
        # would wrap — invert the percentiles host-side from the int64
        # histogram instead (same formulas, f64 intermediates)
        return _stats_finalize_host(hist, count, float(mn), float(mx))
    return fused._stats_finalize(
        jnp.asarray(hist, jnp.int32),
        jnp.asarray(np.int32(count)),
        mn_j, mx_j)


def _stats_finalize_host(hist, count, mn, mx):
    """Host-f64 mirror of fused._stats_finalize for bands whose valid-pixel
    count exceeds int32 (the streamed path exists to remove size ceilings;
    the device finalize keeps bit-parity for everything below it). Moments
    come from the histogram like the device finalize."""
    span = mx - mn
    n = max(float(count), 1.0)
    centers = np.arange(NUM_BINS, dtype=np.float64) + 0.5
    hf = np.asarray(hist[:NUM_BINS], np.float64)
    bw_m = span / NUM_BINS
    m1 = float(np.sum(hf * centers)) / n
    m2 = float(np.sum(hf * centers * centers)) / n
    mean = mn + m1 * bw_m
    var = max(m2 - m1 * m1, 0.0) * bw_m * bw_m
    std = np.sqrt(var) if count > 1 else 0.0
    cum = np.cumsum(hist)
    pct_values = np.asarray(fused._PCT_VALUES, np.float64)
    targets = np.minimum(np.floor(pct_values * n).astype(np.int64), count - 1)
    b = np.minimum(np.searchsorted(cum, targets, side="right"), NUM_BINS - 1)
    h = hist[b]
    cum_before = cum[b] - h
    within = np.maximum(targets - cum_before, 0)
    frac = np.where(h > 0, within.astype(np.float64) / np.maximum(h, 1), 0.0)
    bw = span / NUM_BINS
    pcts = mn + (b.astype(np.float64) + frac) * bw
    if span <= 0:
        pcts = np.where(pct_values <= 0.5, mn, mx)
    d = {k: jnp.float32(v) for k, v in zip(fused._PCT_ORDER, pcts)}
    # dict count saturates at int32 (matching the device dict's dtype; no
    # downstream consumer reads it — the true count was already used above)
    d.update(count=jnp.asarray(np.int32(min(count, np.iinfo(np.int32).max))),
             min=jnp.float32(mn), max=jnp.float32(mx), mean=jnp.float32(mean),
             std=jnp.float32(std))
    return d


def band_u8_streamed(dn, strategy: AutoscaleStrategy,
                     tamed_copol: bool | None = None,
                     bit_depth: BitDepth = BitDepth.U8,
                     chunk_rows: int = CHUNK_ROWS,
                     collect_hist: bool = False,
                     device_hist: bool = False,
                     mesh=None,
                     emit_q16: bool = False):
    """One full-res band DN → u8 (or u16 for grayscale U16), chunked.
    Semantics mirror fused._band_u8 / fused.grayscale_pipeline. With
    `collect_hist`, also returns the u8 output's 256-bin histogram
    (accumulated inside the scale pass — no extra device passes).

    Bands within the device int32-accumulation ceiling run as ONE fused
    device program (stats → window → apply chain, _band_body) and at most
    one host fetch (the collected histogram); larger bands fall back to
    per-chunk passes with host-int64 accumulation. With `device_hist`, a
    device-accumulated histogram is returned as the device int32 array
    (fetch deferred to the caller); host-accumulated bands return host
    int64 regardless.

    With `mesh` (a 'row'-axis device mesh), the band row-shards across the
    devices and runs ONE shard_map program with collectives at the
    reduction points — every strategy stays byte-identical, Adaptive
    included (see _band_body). Falls back to unsharded when the rows don't
    split evenly or the band exceeds the int32 device-accumulation
    ceiling."""
    dn = jnp.asarray(dn)  # numpy input would re-upload per chunk pass
    rows, cols = dn.shape
    # per-chunk int32 reductions require chunk pixels < 2^31; a chunk never
    # exceeds the band (the scanned loop bodies trace at full chunk shape)
    chunk_rows = max(min(chunk_rows, rows, (2**31 - 1) // max(cols, 1)), 1)
    k, tail = _plan(rows, chunk_rows)
    device_acc = dn.size <= _DEVICE_ACC_MAX_PIXELS
    chunks = _chunk_starts(rows, chunk_rows)
    tamed = tamed_copol is not None and strategy is AutoscaleStrategy.TAMED
    if emit_q16 and not device_acc:
        raise ValueError(
            "emit_q16 requires the device-accumulation path (the caller "
            "gates on _DEVICE_ACC_MAX_PIXELS)")

    if mesh is not None:
        n = mesh.shape.get("row", 1)
        if device_acc and n >= 2 and rows % n == 0:
            res = _band_u8_streamed_sharded(
                dn, strategy, tamed_copol, bit_depth, chunk_rows,
                collect_hist, mesh, emit_q16)
            if emit_q16:
                q16, h, mn_j, mx_j = res
                return q16, (h if device_hist
                             else np.asarray(h).astype(np.int64)), \
                    mn_j, mx_j
            out, h = res
            if not collect_hist:
                return out
            to_u8 = tamed or bit_depth is not BitDepth.U16
            if not to_u8:
                return out, np.zeros(256, np.int64)
            return out, (h if device_hist else
                         np.asarray(h).astype(np.int64))
        # name the actual failed condition (row divisibility vs the device
        # int32 accumulation ceiling); a 1-device mesh is simply unsharded
        # execution, not worth an operator warning
        if not device_acc:
            logger.warning(
                "streamed: band (%dx%d) exceeds the int32 device-"
                "accumulation ceiling (%d px); running unsharded",
                rows, cols, _DEVICE_ACC_MAX_PIXELS)
        elif n >= 2:
            logger.warning(
                "streamed: %d rows don't split evenly over %d 'row' "
                "devices; running unsharded", rows, n)

    if device_acc:
        # the whole band — stats, window, apply, scale — is ONE dispatch
        to_u8 = tamed or bit_depth is not BitDepth.U16
        tile_h = -(-rows // TILES_Y)
        tile_w = -(-cols // TILES_X)
        res = _scan_band_full(
            dn, chunk_rows, k, tail, strategy, tamed_copol,
            float(bit_depth.max_val), bit_depth is not BitDepth.U16,
            collect_hist and to_u8, cols, tile_h, tile_w, rows, rows, None,
            emit_q16)
        if emit_q16:
            q16, h, mn_j, mx_j = res
            return q16, (h if device_hist
                         else np.asarray(h).astype(np.int64)), mn_j, mx_j
        out, h = res
        if not collect_hist:
            return out
        if not to_u8:
            return out, np.zeros(256, np.int64)  # u16 never consumes this
        return out, (h if device_hist else np.asarray(h).astype(np.int64))

    # --- host-accumulation path (bands beyond the int32 device ceiling) ---
    s = _band_stats_hostacc(dn, chunks)
    q16 = jnp.zeros((rows, cols), jnp.uint16)
    if tamed:
        # band-specific tamed window goes straight to u8 with NO global
        # rescale (fused._band_u8 / autoscale.rs:710-742)
        low = jnp.where(tamed_copol, jnp.minimum(s["p02"], s["p05"]), s["p05"])
        high = s["p99"]
        q16 = _scan_apply_tamed(q16, dn, low, high, chunk_rows, k, tail)
        u8 = q16.astype(jnp.uint8)
        if not collect_hist:
            return u8
        hist = np.zeros(256, np.int64)
        for r0, n in chunks:
            hist += np.asarray(_pass_u8_hist(u8, r0, n), np.int64)
        return u8, hist
    low, high, gamma = fused._window(s, strategy)
    max_val = jnp.float32(bit_depth.max_val)
    if strategy is AutoscaleStrategy.CLAHE:
        tile_h = -(-rows // TILES_Y)
        tile_w = -(-cols // TILES_X)
        hists = np.zeros(TILES_Y * TILES_X * CLAHE_BINS, np.int64)
        for r0, n in chunks:
            hists += np.asarray(
                _pass_tile_hist(dn, low, high, r0, n, cols, tile_h,
                                tile_w), np.int64)
        hists32 = jnp.asarray(hists, jnp.int32)
        cdfs = _cdfs_from_hists(hists32, rows, cols, tile_h, tile_w)
        q16, mn_j, mx_j = _scan_apply_clahe(q16, dn, low, high, max_val,
                                            cdfs, chunk_rows, k, tail, cols,
                                            tile_h, tile_w)
    else:
        q16, mn_j, mx_j = _scan_apply_window(q16, dn, low, high, gamma,
                                             max_val, chunk_rows, k, tail)

    if bit_depth is BitDepth.U16:
        if not collect_hist:
            return q16
        hist = np.zeros(256, np.int64)  # u16 grayscale never needs this
        return q16, hist
    # global u16 -> u8 double normalization (fused._scale_u16_to_u8); the
    # q16 min/max fold stayed on device, so this phase adds at most ONE
    # fetch (the histogram, when collected)
    u8 = jnp.zeros((rows, cols), jnp.uint8)
    if not collect_hist:
        u8, _h = _scan_scale_u8(u8, q16, mn_j, mx_j, chunk_rows, k, tail,
                                False)
        return u8
    # >int32-pixel band with a collected histogram: per-chunk passes with
    # exact host-int64 accumulation
    hist = np.zeros(256, np.int64)
    for r0, n in chunks:
        u8, h = _pass_scale_u8(u8, q16, mn_j, mx_j, r0, n, with_hist=True)
        hist += np.asarray(h, np.int64)
    return u8, hist


def _suppressed_floor_host(hist: np.ndarray, total_pixels: int):
    """Combined-histogram water floor, int64-exact on the host (the in-graph
    version cumsum's in int32; streamed totals can exceed that)."""
    target = np.floor(np.float64(total_pixels) * 0.05 + 0.5)
    cum = np.cumsum(hist.astype(np.int64))
    reached = cum >= target
    floor_value = int(np.argmax(reached)) if reached.any() else 0
    return jnp.asarray(np.float32(min(floor_value + 3, 40)))


def synrgb_streamed(vv_dn, vh_dn,
                    strategy: AutoscaleStrategy = AutoscaleStrategy.CLAHE,
                    suppressed: bool | None = None, pad: bool = False,
                    chunk_rows: int = CHUNK_ROWS, layout: str = "rgb",
                    mesh=None):
    """Full-res dual-pol DN → synthetic-RGB u8, chunked multi-pass.
    Matches fused.synrgb_pipeline(target_size=None) semantics.

    `layout="dct"` appends the chunked device JPEG front-end and returns
    the host int16 coefficient array for the entropy-only encoder (same
    contract as fused channel_order="dct").

    With `mesh`, the heavy per-band work row-shards across the devices
    (see band_u8_streamed); the cheap u8 pad/compose/DCT tail runs on the
    sharded bands with XLA-propagated shardings."""
    vv_dn = jnp.asarray(vv_dn)
    vh_dn = jnp.asarray(vh_dn)
    rows, cols = vv_dn.shape
    tamed = strategy is AutoscaleStrategy.TAMED
    if suppressed is None:
        suppressed = strategy in (AutoscaleStrategy.TAMED,
                                  AutoscaleStrategy.CLAHE)
    # q16 compose route: the bands stay in their u16
    # staging buffers, the u16→u8 scale folds INTO the compose chunks, and
    # no u8 planes are materialized — one fewer full write+read traversal
    # per band, byte-identical output (see _band_body emit_q16)
    q16_mode = (vv_dn.size <= _DEVICE_ACC_MAX_PIXELS
                and vh_dn.size <= _DEVICE_ACC_MAX_PIXELS)
    # device_hist defers each band's histogram fetch until BOTH bands'
    # programs are dispatched, so band 1's fetch overlaps band 2's compute
    # (hostacc bands return host int64 already)
    r1 = band_u8_streamed(vv_dn, strategy, True if tamed else None,
                          chunk_rows=chunk_rows, collect_hist=suppressed,
                          device_hist=True, mesh=mesh, emit_q16=q16_mode)
    r2 = band_u8_streamed(vh_dn, strategy, False if tamed else None,
                          chunk_rows=chunk_rows, collect_hist=suppressed,
                          device_hist=True, mesh=mesh, emit_q16=q16_mode)
    if q16_mode:
        b1, h1, mn1, mx1 = r1
        b2, h2, mn2, mx2 = r2
    else:
        b1, h1 = r1 if suppressed else (r1, None)
        b2, h2 = r2 if suppressed else (r2, None)
    # release the DN planes: the band programs hold the only remaining
    # uses, so their ~2.8 GB/band (26544² u16) free as each completes
    # instead of riding to the end of the compose
    vv_dn = vh_dn = None
    hist = (np.asarray(h1).astype(np.int64)
            + np.asarray(h2).astype(np.int64)) if suppressed else None
    if pad:
        m = max(rows, cols)
        if suppressed:
            # pad precedes composition (save.rs:332-361): the pad zeros take
            # part in the suppressed mode's combined histogram (q16 pad
            # zeros scale to u8 0 exactly — (0-mn)·scale clips to 0)
            hist[0] += 2 * (m * m - rows * cols)
        b1 = fused._pad_square(b1, rows, cols)
        b2 = fused._pad_square(b2, rows, cols)
        rows = cols = m

    def _finish(rgb_dev):
        return (dct_blocks_streamed(rgb_dev, chunk_rows)
                if layout == "dct" else rgb_dev)

    chunk = max(min(chunk_rows, rows, (2**31 - 1) // max(cols, 1)), 1)
    k, tail = _plan(rows, chunk)
    rgb = jnp.zeros((rows, cols, 3), jnp.uint8)
    if not suppressed:
        if q16_mode:
            rgb = _scan_compose_default_q16(rgb, b1, b2, mn1, mx1, mn2, mx2,
                                            chunk, k, tail)
        else:
            rgb = _scan_compose_default(rgb, b1, b2, chunk, k, tail)
        return _finish(rgb)
    # floor computed HOST-side in int64: totals can exceed int32 (e.g.
    # padded 40000^2 dual-band = 3.2e9); semantics match the reference's
    # integer counting (synthetic_rgb.rs:96-110)
    floor_c = _suppressed_floor_host(hist, 2 * rows * cols)
    lut_r, lut_g, lut_b = fused._suppressed_luts(floor_c)
    if q16_mode:
        rgb = _scan_compose_suppressed_q16(
            rgb, b1, b2, mn1, mx1, mn2, mx2, floor_c, lut_r, lut_g,
            lut_b, chunk, k, tail)
        return _finish(rgb)
    rgb = _scan_compose_suppressed(rgb, b1, b2, floor_c, lut_r, lut_g,
                                  lut_b, chunk, k, tail)
    return _finish(rgb)


def grayscale_streamed(dn, strategy: AutoscaleStrategy = AutoscaleStrategy.STANDARD,
                       bit_depth: BitDepth = BitDepth.U8, pad: bool = False,
                       chunk_rows: int = CHUNK_ROWS, jpeg_dct: bool = False,
                       mesh=None):
    """Full-res single-band DN → u8/u16 grayscale, chunked multi-pass.
    Matches fused.grayscale_pipeline(target_size=None) semantics.

    `jpeg_dct` (U8 only) appends the chunked device JPEG front-end and
    returns the (BH, BW, 8, 8) int16 host coefficient array (same contract
    as fused grayscale_pipeline(jpeg_dct=True)).

    With `mesh`, the band row-shards across the devices
    (see band_u8_streamed)."""
    dn = jnp.asarray(dn)
    rows, cols = dn.shape
    out = band_u8_streamed(dn, strategy, None, bit_depth, chunk_rows,
                           mesh=mesh)
    if pad:
        out = fused._pad_square(out, rows, cols)
    if jpeg_dct:
        assert bit_depth is BitDepth.U8, "JPEG front-end is u8-only"
        return dct_blocks_streamed(out, chunk_rows)[0]
    return out
