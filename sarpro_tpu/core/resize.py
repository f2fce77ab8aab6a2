"""Resampling and padding.

Reference behavior (src/core/processing/resize.rs, padding.rs):
  * long-side target preserving aspect, warn + no-op on upscale (:6-30);
  * Lanczos3 separable convolution over the quantized u8/u16 image (:32-89);
  * skip-if-already-at-target early return, optional square zero-padding, and
    the (scale_x, scale_y, pad_left, pad_top) metadata (:91-236);
  * center padding into max_dim² (padding.rs:5-49).

Device design: resampling is a separable weighted gather — for each output row a
fixed window of K input rows and a (out, K) weight matrix, precomputed on the
host in f64 (Pillow/fast_image_resize convolution bounds+normalization), then
applied on device as gather + einsum along each axis. Static shapes; the
weight tables are tiny and enter the jit as arrays, so images of the same
(in, out) shape share one compiled program.

The same machinery implements the reader's downsample-on-read filters
(nearest / bilinear / cubic / lanczos / average) that the reference gets from
GDAL RasterIO (src/io/gdal.rs:145-177).
"""
from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np

from ..types import BitDepth
from .numerics import round_half_up_nonneg

logger = logging.getLogger("sarpro")


def calculate_resize_dimensions(
    original_cols: int, original_rows: int, target_size: int
) -> tuple[int, int]:
    """Long-side target preserving aspect ratio (reference: resize.rs:6-30)."""
    short_side = min(original_rows, original_cols)
    long_side = max(original_rows, original_cols)
    if target_size > long_side:
        logger.warning(
            "Target size %d is larger than original long side %d. "
            "Keeping original dimensions %dx%d",
            target_size, long_side, original_cols, original_rows,
        )
        return original_cols, original_rows
    scale_factor = target_size / long_side
    new_short_side = int(np.floor(short_side * scale_factor + 0.5))
    if original_cols > original_rows:
        return target_size, new_short_side
    return new_short_side, target_size


# --------------------------------------------------------------------------
# Filter kernels (Pillow / fast_image_resize convolution family)
# --------------------------------------------------------------------------
def _lanczos3(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.sinc(x) * np.sinc(x / 3.0)  # np.sinc includes the pi factor
    return np.where(ax < 3.0, s, 0.0)


def _bilinear(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax < 1.0, 1.0 - ax, 0.0)


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic convolution (a=-0.5, the GDAL/Catmull-Rom-style kernel)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w1 = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    w2 = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    return np.where(ax < 1.0, w1, np.where(ax < 2.0, w2, 0.0))


def _box(x: np.ndarray) -> np.ndarray:
    return np.where(np.abs(x) <= 0.5, 1.0, 0.0)


_FILTERS = {
    "lanczos": (_lanczos3, 3.0),
    "lanczos3": (_lanczos3, 3.0),
    "bilinear": (_bilinear, 1.0),
    "cubic": (_cubic, 2.0),
    "average": (_box, 0.5),
    "box": (_box, 0.5),
}


@functools.lru_cache(maxsize=64)
def _build_coeffs(in_size: int, out_size: int, filter_name: str):
    """Precompute per-output-sample bounds and normalized weights
    (the Pillow `precompute_coeffs` convolution used by fast_image_resize,
    which the reference invokes at resize.rs:39-51)."""
    fn, base_support = _FILTERS[filter_name]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1

    if ksize < 128:
        # vectorized form of the per-row loop below: identical f64 values
        # at every tap, and because ksize < numpy's pairwise-summation
        # blocksize (128) the masked row sums add the same taps in the
        # same sequential order (trailing +0.0 is exact), so the
        # normalized weights are bit-identical to the loop's. The loop
        # cost ~94 ms for a 20000→2048 axis — on every cold process this
        # was the read stage's largest non-DRAM term.
        centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
        xmin = np.maximum((centers - support + 0.5).astype(np.int64), 0)
        xmax = np.minimum((centers + support + 0.5).astype(np.int64),
                          in_size)
        idx = xmin[:, None] + np.arange(ksize, dtype=np.int64)[None, :]
        valid = idx < xmax[:, None]
        k = fn((idx - centers[:, None] + 0.5) / filterscale)
        k = np.where(valid, k, 0.0)
        ssum = k.sum(axis=1)
        k = np.where((ssum != 0.0)[:, None],
                     k / np.where(ssum == 0.0, 1.0, ssum)[:, None], k)
        # cache plain numpy: jnp constants created inside one trace must
        # not be reused by another (tracer leak via the lru_cache)
        return xmin.astype(np.int32), k.astype(np.float32)

    starts = np.zeros(out_size, np.int32)
    weights = np.zeros((out_size, ksize), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        n = xmax - xmin
        k = fn((np.arange(xmin, xmax) - center + 0.5) / filterscale)
        ssum = k.sum()
        if ssum != 0.0:
            k = k / ssum
        starts[i] = xmin
        weights[i, :n] = k
    # cache plain numpy: jnp constants created inside one trace must not be
    # reused by another (tracer leak via the lru_cache)
    return starts, weights.astype(np.float32)


_TAP_LOOP_MAX = 24
# Precision of the > _TAP_LOOP_MAX contraction, read when it is traced: on
# the GPU a DEFAULT-precision f32 dot may run in TF32 (~3 decimal digits).
CONTRACTION_PRECISION = jax.lax.Precision.HIGHEST


@jax.jit
def _resample_axis0(x, starts, weights):
    """Weighted gather along axis 0: out[i] = Σ_k w[i,k] · x[starts[i]+k].

    For small tap counts, unroll a static loop of whole-row gathers — each is
    a contiguous-row copy that XLA fuses into one loop with the multiply-adds
    — instead of one giant (out, K, cols) gather that materializes K× the
    output. The source may be integer-typed (DN rasters): rows are gathered
    in the narrow dtype and cast after, halving memory traffic for u16
    inputs. Large reductions (> _TAP_LOOP_MAX taps, e.g. lanczos
    20000 -> 1024) contract the gathered window at CONTRACTION_PRECISION.
    """
    k = weights.shape[1]
    if k <= _TAP_LOOP_MAX:
        out = None
        for j in range(k):
            idx = jnp.clip(starts + j, 0, x.shape[0] - 1)
            rows = jnp.take(x, idx, axis=0).astype(jnp.float32)
            term = weights[:, j:j + 1] * rows
            out = term if out is None else out + term
        return out
    idx = jnp.clip(starts[:, None] + jnp.arange(k, dtype=jnp.int32)[None, :],
                   0, x.shape[0] - 1)
    g = jnp.take(x, idx.reshape(-1), axis=0).reshape(idx.shape + x.shape[1:])
    return jnp.einsum("ok,okc->oc", weights, g.astype(jnp.float32),
                      preferred_element_type=jnp.float32,
                      precision=CONTRACTION_PRECISION)


@jax.jit
def _nearest_axis0(x, idx):
    return jnp.take(x, idx, axis=0)


def _apply_axis0(x, filter_name: str, in_n: int, out_n: int):
    """Axis-0 resample of `x` from in_n to out_n rows with `filter_name`'s
    coefficients (per-tap f32 sum order is part of the quantized resize's
    Pillow-exactness contract)."""
    s, w = _build_coeffs(in_n, out_n, filter_name)
    return _resample_axis0(x, jnp.asarray(s), jnp.asarray(w))


def resample_plane(
    x, out_rows: int, out_cols: int, filter_name: str = "lanczos3"
) -> jax.Array:
    """Separable resample of a 2D f32 plane to (out_rows, out_cols)."""
    x = jnp.asarray(x, jnp.float32)
    in_rows, in_cols = x.shape
    if filter_name in ("nearest", "near"):
        ri = np.minimum(((np.arange(out_rows) + 0.5) * (in_rows / out_rows)).astype(np.int64), in_rows - 1)
        ci = np.minimum(((np.arange(out_cols) + 0.5) * (in_cols / out_cols)).astype(np.int64), in_cols - 1)
        y = _nearest_axis0(x, jnp.asarray(ri, jnp.int32))
        return _nearest_axis0(y.T, jnp.asarray(ci, jnp.int32)).T
    if in_rows != out_rows:
        x = _apply_axis0(x, filter_name, in_rows, out_rows)
    if in_cols != out_cols:
        x = _apply_axis0(x.T, filter_name, in_cols, out_cols).T
    return x


@jax.jit
def _round_clamp_cast_u8(x):
    return jnp.clip(round_half_up_nonneg(x), 0.0, 255.0).astype(jnp.uint8)


@jax.jit
def _round_clamp_cast_u16(x):
    return jnp.clip(round_half_up_nonneg(x), 0.0, 65535.0).astype(jnp.uint16)


def _resize_quantized(data, original_cols, original_rows, target_cols, target_rows,
                      cast):
    """Two-pass Lanczos3 with *integer intermediate*: Pillow/fast_image_resize
    run horizontal-then-vertical convolution through an integer-typed buffer
    (the reference's resizer operates on U8/U16 images — resize.rs:39-51), so
    we quantize between the passes to match."""
    x = jnp.asarray(data).reshape(original_rows, original_cols).astype(jnp.float32)
    if original_cols != target_cols:
        x = cast(_apply_axis0(x.T, "lanczos3", original_cols,
                              target_cols).T).astype(jnp.float32)
    if original_rows != target_rows:
        x = _apply_axis0(x, "lanczos3", original_rows, target_rows)
    return cast(x)


def resize_u8_image(data, original_cols, original_rows, target_cols, target_rows):
    """Lanczos3 resize of a u8 plane (reference: resize.rs:32-53)."""
    return _resize_quantized(data, original_cols, original_rows, target_cols,
                             target_rows, _round_clamp_cast_u8)


def resize_u16_image(data, original_cols, original_rows, target_cols, target_rows):
    """True-u16 Lanczos3 resize, no down-conversion (reference: resize.rs:55-89)."""
    return _resize_quantized(data, original_cols, original_rows, target_cols,
                             target_rows, _round_clamp_cast_u16)


# --------------------------------------------------------------------------
# Padding (reference: src/core/processing/padding.rs:5-49)
# --------------------------------------------------------------------------
def add_padding_to_square(u8_data, u16_data, cols: int, rows: int, bit_depth: BitDepth):
    """Center the image in a max_dim² zero canvas; returns (u8, u16)."""
    max_dim = max(cols, rows)
    pad_cols = (max_dim - cols) // 2
    pad_rows = (max_dim - rows) // 2
    logger.info(
        "Adding padding: cols=%d, rows=%d, pad_cols=%d, pad_rows=%d; final %dx%d",
        cols, rows, pad_cols, pad_rows, max_dim, max_dim,
    )

    def _pad(arr):
        a = jnp.asarray(arr).reshape(rows, cols)
        return jnp.pad(
            a,
            (
                (pad_rows, max_dim - rows - pad_rows),
                (pad_cols, max_dim - cols - pad_cols),
            ),
        )

    if bit_depth is BitDepth.U8:
        return _pad(u8_data), None
    if u16_data is None:
        raise ValueError("U16 data required for U16 bit depth")
    return None, _pad(u16_data)


# --------------------------------------------------------------------------
# Orchestration (reference: resize.rs:91-257)
# --------------------------------------------------------------------------
def resize_image_data_with_meta(
    u8_data,
    u16_data,
    original_cols: int,
    original_rows: int,
    target_size: int | None,
    bit_depth: BitDepth,
    pad: bool,
):
    """Resize + optional pad with geotransform metadata. Returns
    (final_cols, final_rows, u8, u16, scale_x, scale_y, pad_left, pad_top) —
    same tuple as the reference (resize.rs:99-110).

    Arrays in/out are 2D device arrays (u8 slot used for U8 depth, u16 slot
    for U16), `None` in the inactive slot.
    """

    def _finish(u8, u16, cols, rows, sx, sy):
        if pad:
            p8, p16 = add_padding_to_square(u8, u16, cols, rows, bit_depth)
            final_dim = max(cols, rows)
            return (
                final_dim, final_dim, p8, p16, sx, sy,
                (final_dim - cols) // 2, (final_dim - rows) // 2,
            )
        return cols, rows, u8, u16, sx, sy, 0, 0

    if target_size is not None:
        logger.info("Resizing image to %d (long side)", target_size)
        current_long = max(original_cols, original_rows)
        if current_long == target_size:
            # already at requested long side — skip resize (reference: :115-145)
            return _finish(u8_data, u16_data, original_cols, original_rows, 1.0, 1.0)
        new_cols, new_rows = calculate_resize_dimensions(
            original_cols, original_rows, target_size
        )
        logger.info(
            "Original size: %dx%d, New size: %dx%d",
            original_cols, original_rows, new_cols, new_rows,
        )
        if bit_depth is BitDepth.U8:
            r8 = resize_u8_image(u8_data, original_cols, original_rows, new_cols, new_rows)
            r16 = None
        else:
            if u16_data is None:
                raise ValueError("U16 data required for U16 bit depth")
            r8 = None
            r16 = resize_u16_image(u16_data, original_cols, original_rows, new_cols, new_rows)
        scale_x = new_cols / original_cols
        scale_y = new_rows / original_rows
        return _finish(r8, r16, new_cols, new_rows, scale_x, scale_y)

    return _finish(u8_data, u16_data, original_cols, original_rows, 1.0, 1.0)


def resize_image_data(u8_data, u16_data, original_cols, original_rows,
                      target_size, bit_depth, pad):
    """Tuple-reduced variant (reference: resize.rs:238-257)."""
    c, r, u8v, u16v, _sx, _sy, _pl, _pt = resize_image_data_with_meta(
        u8_data, u16_data, original_cols, original_rows, target_size, bit_depth, pad
    )
    return c, r, u8v, u16v
