"""Histograms and small-table lookups of the per-pixel chain, in plain XLA.

Histograms are XLA scatter-adds (exact int32 counts; under GSPMD or
shard_map they become per-shard partials plus a reduction). The lookups
(CLAHE bilinear CDF blend, synRGB LUTs) are gathers that XLA fuses with
their index arithmetic; the tables (64 KB CDFs, 64 KB blue LUT) stay
cache-resident on the GPU.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Histogram
# ---------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("num_bins",))
def histogram(idx, num_bins: int):
    """Counts of idx values in [0, num_bins) as int32 (num_bins,); other
    values (the mask convention is idx == num_bins) are not counted.
    `idx` is an integer array of any shape."""
    if not jnp.issubdtype(idx.dtype, jnp.integer):
        raise TypeError(f"histogram needs integer input, got {idx.dtype}")
    idx = idx.reshape(-1).astype(jnp.int32)
    valid = (idx >= 0) & (idx < num_bins)
    safe = jnp.where(valid, idx, 0)
    return jnp.zeros((num_bins,), jnp.int32).at[safe].add(valid.astype(jnp.int32))


# ---------------------------------------------------------------------------
# CLAHE tile histograms
# ---------------------------------------------------------------------------
@functools.partial(
    jax.jit,
    static_argnames=("cols", "tiles_x", "tiles_y", "tile_h", "tile_w",
                     "n_bins"))
def _tile_index(bin_flat, cols, tiles_x, tiles_y, tile_h, tile_w, n_bins,
                row_offset=None):
    """Flat (tile * n_bins + bin) index of every pixel; masked pixels
    (bin >= n_bins) carry the overflow index tiles * n_bins."""
    flat_idx = jnp.arange(bin_flat.size, dtype=jnp.int32)
    r = flat_idx // cols
    if row_offset is not None:
        r = r + jnp.asarray(row_offset, jnp.int32)
    c = flat_idx % cols
    ty = jnp.minimum(r // tile_h, tiles_y - 1)
    tx = jnp.minimum(c // tile_w, tiles_x - 1)
    n_hist = tiles_y * tiles_x * n_bins
    return jnp.where(bin_flat < n_bins, (ty * tiles_x + tx) * n_bins + bin_flat,
                     n_hist)


def tile_histogram(bin_flat, cols, tiles_x, tiles_y, tile_h, tile_w,
                   row_offset=None, n_bins: int = 256):
    """Per-tile histograms for CLAHE (reference: autoscale.rs:258-269).

    `bin_flat` is the flat row-major (N,) bin array for a (N/cols, cols)
    image; `bin_flat == n_bins` marks invalid pixels (not counted).
    `row_offset` (static int or traced scalar) shifts pixel rows to global
    raster coordinates for row chunks/shards. Returns the flat
    (tiles_y*tiles_x*n_bins,) i32 counts, tile-major."""
    idx = _tile_index(jnp.asarray(bin_flat).reshape(-1).astype(jnp.int32),
                      cols, tiles_x, tiles_y, tile_h, tile_w, n_bins,
                      row_offset=row_offset)
    return histogram(idx, tiles_y * tiles_x * n_bins)


# ---------------------------------------------------------------------------
# CLAHE bilinear CDF lookup
# ---------------------------------------------------------------------------
@functools.partial(
    jax.jit,
    static_argnames=("cols", "tiles_x", "tiles_y", "tile_h", "tile_w"))
def clahe_lookup(bin_idx, cdfs, cols, tiles_x, tiles_y, tile_h, tile_w,
                 row_offset=None):
    """Bilinear interpolation between the 4 neighbor-tile CDFs at each
    pixel's bin (reference: autoscale.rs:307-343). `bin_idx` is the flat
    row-major (N,) bin array for a (N/cols, cols) image; `bin_idx == n_bins`
    marks invalid pixels -> 0. `row_offset` (traced scalar) shifts pixel rows
    to global raster coordinates for row-sharded shards. Returns (N,) f32."""
    flat = jnp.arange(bin_idx.size, dtype=jnp.int32)
    r = flat // cols
    if row_offset is not None:
        r = r + jnp.asarray(row_offset, jnp.int32)
    c = flat % cols
    rf = r.astype(jnp.float32) / np.float32(tile_h) - 0.5
    cf = c.astype(jnp.float32) / np.float32(tile_w) - 0.5
    tyf = jnp.maximum(jnp.floor(rf), 0.0)
    txf = jnp.maximum(jnp.floor(cf), 0.0)
    dy = rf - tyf
    dx = cf - txf
    tyi = tyf.astype(jnp.int32)
    txi = txf.astype(jnp.int32)
    ty0 = jnp.clip(tyi, 0, tiles_y - 1)
    tx0 = jnp.clip(txi, 0, tiles_x - 1)
    ty1 = jnp.clip(tyi + 1, 0, tiles_y - 1)
    tx1 = jnp.clip(txi + 1, 0, tiles_x - 1)
    n_tiles, n_bins = cdfs.shape
    table = cdfs.ravel()
    safe_bin = jnp.minimum(bin_idx, n_bins - 1)
    valid = bin_idx < n_bins

    def at(a, b):
        return jnp.take(table, (a * tiles_x + b) * n_bins + safe_bin)

    top = at(ty0, tx0) * (1 - dx) + at(ty0, tx1) * dx
    bot = at(ty1, tx0) * (1 - dx) + at(ty1, tx1) * dx
    return jnp.where(valid, top * (1 - dy) + bot * dy, 0.0)


# ---------------------------------------------------------------------------
# synRGB LUT lookup (1D r/g tables + 2D blue table)
# ---------------------------------------------------------------------------
@jax.jit
def synrgb_lookup(b1, b2, lut_r, lut_g, lut_b):
    """(N,3) u8 from u8 bands + 256/256/65536 LUTs (flat N inputs)."""
    i1 = b1.astype(jnp.int32).reshape(-1)
    i2 = b2.astype(jnp.int32).reshape(-1)
    r = jnp.take(lut_r, i1)
    g = jnp.take(lut_g, i2)
    b = jnp.take(lut_b.reshape(-1), i1 * 256 + i2)
    return jnp.stack([r, g, b], axis=-1).astype(jnp.uint8)
