"""Tests for ops/kernels.py: the histogram, tile histogram, CLAHE lookup
and synRGB lookup, and io.warp's sampler, against numpy oracles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sarpro_tpu.ops import kernels as K


def _values(rng, n, num_bins, dist):
    if dist == "skewed":  # SAR dB crowd: a few hundred bins carry the mass
        v = rng.normal(num_bins * 0.4, num_bins / 40, n)
    else:
        v = rng.uniform(0, num_bins, n)
    return np.clip(v, 0, num_bins - 1).astype(np.int32)


@pytest.mark.parametrize("num_bins", [256, 4096, 16384])
@pytest.mark.parametrize("dist", ["skewed", "uniform"])
def test_histogram_matches_bincount(rng, num_bins, dist):
    n = 10_007  # ragged: no multiple of any vector width
    bins = _values(rng, n, num_bins, dist)
    mask = rng.random(n) < 0.9
    idx = np.where(mask, bins, num_bins)  # the mask convention
    idx[:3] = [-1, num_bins + 5, np.iinfo(np.int32).max]  # out of range
    mask[:3] = False
    got = np.asarray(K.histogram(jnp.asarray(idx), num_bins))
    want = np.bincount(bins[mask], minlength=num_bins)
    assert got.dtype == np.int32 and got.shape == (num_bins,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1,), (37, 53), (3, 5, 7)])
def test_histogram_u8_any_shape(rng, shape):
    x = rng.integers(0, 256, shape).astype(np.uint8)
    got = np.asarray(K.histogram(jnp.asarray(x), 256))
    np.testing.assert_array_equal(got, np.bincount(x.ravel(), minlength=256))


def test_histogram_rejects_float():
    with pytest.raises(TypeError):
        K.histogram(jnp.zeros((8,), jnp.float32), 256)


def _tile_oracle(bins, cols, tiles, tile_h, tile_w, row_off=0, n_bins=256):
    hist = np.zeros((tiles * tiles, n_bins), np.int64)
    for i, v in enumerate(bins):
        if v >= n_bins:
            continue
        r, c = divmod(i, cols)
        ty = min((r + row_off) // tile_h, tiles - 1)
        tx = min(c // tile_w, tiles - 1)
        hist[ty * tiles + tx, v] += 1
    return hist.reshape(-1)


@pytest.mark.parametrize("row_offset,tile_scale", [
    (None, 1), (16, 2), ("traced", 2)])
def test_tile_histogram_matches_numpy(rng, row_offset, tile_scale):
    """tile_histogram (tile*256+bin index feeding the histogram) vs a direct
    numpy per-tile count, incl. masked pixels, partial bottom/right tiles,
    and the row_offset chunk/shard path (static and traced)."""
    rows, cols, tiles = 37, 53, 8
    tile_h = -(-rows // tiles) * tile_scale
    tile_w = -(-cols // tiles)
    bins = rng.integers(0, 257, rows * cols).astype(np.int32)  # 256 = masked
    off = row_offset
    if row_offset == "traced":
        off = 11
        fn = jax.jit(lambda b, o: K.tile_histogram(
            b, cols, tiles, tiles, tile_h, tile_w, row_offset=o))
        got = np.asarray(fn(jnp.asarray(bins), jnp.int32(off)))
    else:
        got = np.asarray(K.tile_histogram(jnp.asarray(bins), cols, tiles,
                                          tiles, tile_h, tile_w,
                                          row_offset=row_offset))
    want = _tile_oracle(bins, cols, tiles, tile_h, tile_w, off or 0)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == int((bins < 256).sum())


def _clahe_oracle(bins, cdfs, cols, tile_h, tile_w, row_off=0):
    want = np.zeros(bins.size)
    for p, b in enumerate(bins):
        if b >= 256:
            continue
        r, c = divmod(p, cols)
        rf = np.float32(r + row_off) / np.float32(tile_h) - 0.5
        cf = np.float32(c) / np.float32(tile_w) - 0.5
        ty = int(max(np.floor(rf), 0))
        tx = int(max(np.floor(cf), 0))
        dy = rf - ty
        dx = cf - tx
        ty0, tx0 = min(ty, 7), min(tx, 7)
        ty1, tx1 = min(ty + 1, 7), min(tx + 1, 7)
        c00 = cdfs[ty0 * 8 + tx0, b]
        c01 = cdfs[ty0 * 8 + tx1, b]
        c10 = cdfs[ty1 * 8 + tx0, b]
        c11 = cdfs[ty1 * 8 + tx1, b]
        want[p] = ((c00 * (1 - dx) + c01 * dx) * (1 - dy)
                   + (c10 * (1 - dx) + c11 * dx) * dy)
    return want


@pytest.mark.parametrize("row_offset", [None, 40])
def test_clahe_lookup_matches_direct(rng, row_offset):
    rows, cols = 96, 80
    n = rows * cols
    bins = rng.integers(0, 256, n).astype(np.int32)
    mask = rng.random(n) < 0.95
    bin_idx = np.where(mask, bins, 256)
    cdfs = rng.random((64, 256)).astype(np.float32)
    tile_h, tile_w = 12, 10
    got = np.asarray(K.clahe_lookup(
        jnp.asarray(bin_idx), jnp.asarray(cdfs), cols, 8, 8, tile_h, tile_w,
        row_offset=row_offset))
    want = _clahe_oracle(bin_idx, cdfs, cols, tile_h, tile_w,
                         row_offset or 0)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.all(got[~mask] == 0.0)


def test_synrgb_lookup_matches_tables(rng):
    n = 5000
    b1 = rng.integers(0, 256, n).astype(np.uint8)
    b2 = rng.integers(0, 256, n).astype(np.uint8)
    lut_r = rng.integers(0, 256, 256).astype(np.uint8)
    lut_g = rng.integers(0, 256, 256).astype(np.uint8)
    lut_b = rng.integers(0, 256, 256 * 256).astype(np.uint8)
    got = np.asarray(K.synrgb_lookup(
        jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(lut_r),
        jnp.asarray(lut_g), jnp.asarray(lut_b)
    ))
    np.testing.assert_array_equal(got[:, 0], lut_r[b1])
    np.testing.assert_array_equal(got[:, 1], lut_g[b2])
    np.testing.assert_array_equal(
        got[:, 2], lut_b[b1.astype(np.int64) * 256 + b2]
    )


def _warp_oracle(src, map_x, map_y, out_rows, out_cols, method):
    """f64 numpy oracle of io.warp._warp_sample: bilinear upsampling of the
    coarse mapping grid, then near/bilinear/cubic (Keys a=-0.5) sampling
    with out-of-bounds taps dropped and the weights renormalised."""
    h, w = src.shape
    gh, gw = map_x.shape
    r, c = np.meshgrid(np.arange(out_rows, dtype=np.float64),
                       np.arange(out_cols, dtype=np.float64), indexing="ij")
    gr = r * ((gh - 1) / max(out_rows - 1, 1))
    gc = c * ((gw - 1) / max(out_cols - 1, 1))
    gr0 = np.clip(np.floor(gr), 0, gh - 2).astype(int)
    gc0 = np.clip(np.floor(gc), 0, gw - 2).astype(int)
    fr, fc = gr - gr0, gc - gc0

    def interp(g):
        top = g[gr0, gc0] * (1 - fc) + g[gr0, gc0 + 1] * fc
        bot = g[gr0 + 1, gc0] * (1 - fc) + g[gr0 + 1, gc0 + 1] * fc
        return top * (1 - fr) + bot * fr

    sx, sy = interp(map_x), interp(map_y)

    def fetch(iy, ix):
        ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        return np.where(ok, src[np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)],
                        0.0), ok

    if method == "near":
        return fetch(np.floor(sy + 0.5).astype(int),
                     np.floor(sx + 0.5).astype(int))[0]

    def keys(t, a=-0.5):
        at = np.abs(t)
        return np.where(at < 1, (a + 2) * at**3 - (a + 3) * at**2 + 1,
                        np.where(at < 2, a * at**3 - 5 * a * at**2
                                 + 8 * a * at - 4 * a, 0.0))

    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    fx, fy = sx - x0, sy - y0
    taps = (range(0, 2) if method == "bilinear" else range(-1, 3))
    val = np.zeros_like(sx)
    wsum = np.zeros_like(sx)
    for dy in taps:
        wy = (1 - np.abs(fy - dy)) if method == "bilinear" else keys(fy - dy)
        for dx in taps:
            wx = ((1 - np.abs(fx - dx)) if method == "bilinear"
                  else keys(fx - dx))
            v, ok = fetch(y0 + dy, x0 + dx)
            val += v * wx * wy * ok
            wsum += wx * wy * ok
    floor = 0.0 if method == "bilinear" else 1e-6
    return np.where(wsum > floor, val / np.maximum(wsum, 1e-20), 0.0)


@pytest.mark.parametrize("method", ["near", "bilinear", "cubic"])
def test_warp_sampler_matches_numpy(rng, method):
    from sarpro_tpu.io import warp as warp_mod

    src = rng.lognormal(3.0, 0.5, (40, 50)).astype(np.float32)
    out_rows, out_cols = 33, 29
    gy, gx = np.meshgrid(np.linspace(0, 1, 5), np.linspace(0, 1, 6),
                         indexing="ij")
    # a rotated, scaled map that runs off the source on two edges; the
    # 0.3 px offset keeps nearest sampling away from rounding ties
    map_x = 0.3 + 55.0 * gx + 6.0 * gy
    map_y = 0.3 - 4.0 * gx + 44.0 * gy
    got = np.asarray(warp_mod._warp_sample(
        jnp.asarray(src), jnp.asarray(map_x, jnp.float32),
        jnp.asarray(map_y, jnp.float32), out_rows, out_cols, method))
    want = _warp_oracle(src.astype(np.float64), map_x, map_y, out_rows,
                        out_cols, method)
    assert got.shape == (out_rows, out_cols)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    assert (got == 0).any() and (got > 0).any()  # both edges exercised
