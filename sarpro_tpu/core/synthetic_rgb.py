"""Synthetic RGB composition from two u8 SAR bands.

Reference semantics (src/core/processing/synthetic_rgb.rs):
  * default mode (:10-67): R = LUT256(band1, γ=0.7), G = LUT256(band2, γ=0.9),
    B = LUT65536 over (band1, band2) of (R/G)^0.1 · 255 · 0.24 with the
    band2==0 → blue=0 guard and g==0 → ratio=inf → clamp 255 behavior;
  * suppressed mode for Tamed/CLAHE (:88-178): combined-band p05 floor (+3
    cushion, capped at 40), floor-subtracted LUTs with γ 1.15/1.10, epsilon-
    stabilized blue ratio with gain 0.18, both-below-floor pixels → black;
  * mode dispatchers (:72-79, :182-197) — all SyntheticRgbMode values alias
    Default (deliberate; confirmed at CHANGELOG.md:70-71).

Device structure: the LUTs are built host-side in float32 numpy —
bit-identical to the reference's f32 LUT precomputation — and applied on
device as three gathers from cache-resident tables (256 B + 256 B + 64 KB).
Output is (H, W, 3) interleaved u8.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..types import AutoscaleStrategy, SyntheticRgbMode

GAMMA_R = np.float32(0.7)
GAMMA_G = np.float32(0.9)
GAMMA_B = np.float32(0.1)
BLUE_SCALE = np.float32(0.24)

GAMMA_R_SUPP = np.float32(1.15)
GAMMA_G_SUPP = np.float32(1.10)
BLUE_SCALE_SUPP = np.float32(0.18)
EPS_SUPP = np.float32(8.0)


def _round_half_away_f32(x: np.ndarray) -> np.ndarray:
    return np.trunc(x + np.copysign(np.float32(0.5), x).astype(np.float32))


@functools.lru_cache(maxsize=1)
def default_luts() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Precompute the default-mode LUTs (reference: synthetic_rgb.rs:20-51).

    f32 arithmetic throughout, round half away from zero, matching Rust.
    """
    v = np.arange(256, dtype=np.float32) / np.float32(255.0)
    # (vf^γ * 255).round().clamp(0,255) as u8  — round THEN clamp
    lut_r = np.clip(_round_half_away_f32(np.power(v, GAMMA_R) * np.float32(255.0)), 0, 255).astype(np.uint8)
    lut_g = np.clip(_round_half_away_f32(np.power(v, GAMMA_G) * np.float32(255.0)), 0, 255).astype(np.uint8)

    r = lut_r.astype(np.float32)[:, None]  # indexed by b1
    g = lut_g.astype(np.float32)[None, :]  # indexed by b2
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = r / g  # g==0 -> inf (b1=0 -> 0/0 = nan; but lut_r[0]=0, g==0 only when b2 small)
        blue_f = np.power(ratio, GAMMA_B) * np.float32(255.0) * BLUE_SCALE
    # (ratio^γ * 255 * 0.24).clamp(0,255).round() as u8 — clamp THEN round
    blue_f = np.nan_to_num(blue_f, nan=0.0, posinf=np.inf)
    blue = _round_half_away_f32(np.clip(blue_f, 0.0, 255.0)).astype(np.uint8)
    # band2 == 0 -> blue = 0 guard (reference: :38-39)
    blue[:, 0] = 0
    return lut_r, lut_g, blue.reshape(-1)  # blue flat index = (b1 << 8) | b2


def _apply_luts(band1, band2, lut_r, lut_g, lut_b):
    from ..ops import synrgb_lookup

    rgb = synrgb_lookup(band1.ravel(), band2.ravel(), jnp.asarray(lut_r),
                        jnp.asarray(lut_g), jnp.asarray(lut_b))
    return rgb.reshape(band1.shape + (3,))


def create_synthetic_rgb(band1, band2) -> jax.Array:
    """Default synRGB (reference: synthetic_rgb.rs:10-67). Inputs u8 arrays
    of identical shape; returns (..., 3) u8."""
    lut_r, lut_g, lut_b = default_luts()
    return _apply_luts(
        jnp.asarray(band1), jnp.asarray(band2),
        jnp.asarray(lut_r), jnp.asarray(lut_g), jnp.asarray(lut_b),
    )


@jax.jit
def _combined_hist_256(band1, band2):
    from ..ops import histogram

    return histogram(band1, 256) + histogram(band2, 256)


def _suppressed_floor(band1, band2) -> int:
    """Combined-histogram p05 floor with cushion (reference: synthetic_rgb.rs:92-113)."""
    hist = np.asarray(_combined_hist_256(jnp.asarray(band1), jnp.asarray(band2)), dtype=np.uint64)
    total = int(band1.size + band2.size)
    target = int(np.floor(total * 0.05 + 0.5))  # .round() as u32, non-negative
    cum = np.cumsum(hist)
    floor_value = 0
    idx = np.nonzero(cum >= target)[0]
    if idx.size:
        floor_value = int(idx[0])
    return min(floor_value + 3, 40)


def suppressed_luts(floor_with_cushion: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """LUTs for the maritime-suppressed mapping (reference: synthetic_rgb.rs:115-154)."""
    floor = np.float32(floor_with_cushion)
    denom = np.float32(max(255.0 - float(floor_with_cushion), 1.0))
    v = np.arange(256, dtype=np.float32)
    shifted = (v - floor) / denom
    r_f = _round_half_away_f32(np.power(shifted, GAMMA_R_SUPP, where=shifted > 0, out=np.zeros_like(shifted)) * np.float32(255.0))
    g_f = _round_half_away_f32(np.power(shifted, GAMMA_G_SUPP, where=shifted > 0, out=np.zeros_like(shifted)) * np.float32(255.0))
    lut_r = np.clip(r_f, 0, 255).astype(np.uint8)
    lut_g = np.clip(g_f, 0, 255).astype(np.uint8)
    below = v <= floor  # `(v as u8) <= floor_with_cushion` (reference: :125)
    lut_r[below] = 0
    lut_g[below] = 0

    r = lut_r.astype(np.float32)[:, None]
    g = lut_g.astype(np.float32)[None, :]
    ratio = (r + EPS_SUPP) / (g + EPS_SUPP)
    blue_f = np.power(ratio, GAMMA_B) * np.float32(255.0) * BLUE_SCALE_SUPP
    blue = _round_half_away_f32(np.clip(blue_f, 0.0, 255.0)).astype(np.uint8)
    return lut_r, lut_g, blue.reshape(-1)


@jax.jit
def _water_mask(band1, band2, rgb, floor_c):
    b1 = band1.astype(jnp.int32)
    b2 = band2.astype(jnp.int32)
    water = (b1 <= floor_c) & (b2 <= floor_c)
    return jnp.where(water[..., None], jnp.uint8(0), rgb)


def _apply_suppressed(band1, band2, lut_r, lut_g, lut_b, floor_c):
    rgb = _apply_luts(band1, band2, lut_r, lut_g, lut_b)
    return _water_mask(jnp.asarray(band1), jnp.asarray(band2), rgb, floor_c)


def create_synthetic_rgb_suppressed(band1, band2) -> jax.Array:
    """Maritime-suppressed synRGB (reference: synthetic_rgb.rs:88-178)."""
    floor_c = _suppressed_floor(np.asarray(band1), np.asarray(band2))
    lut_r, lut_g, lut_b = suppressed_luts(floor_c)
    return _apply_suppressed(
        jnp.asarray(band1), jnp.asarray(band2),
        jnp.asarray(lut_r), jnp.asarray(lut_g), jnp.asarray(lut_b),
        jnp.int32(floor_c),
    )


def create_synthetic_rgb_by_mode(mode: SyntheticRgbMode, band1, band2) -> jax.Array:
    """All modes currently alias Default (reference: synthetic_rgb.rs:72-79)."""
    return create_synthetic_rgb(band1, band2)


def create_synthetic_rgb_by_mode_and_strategy(
    mode: SyntheticRgbMode, strategy: AutoscaleStrategy, band1, band2
) -> jax.Array:
    """Tamed/CLAHE → suppressed mapping, otherwise default
    (reference: synthetic_rgb.rs:182-197)."""
    if strategy in (AutoscaleStrategy.TAMED, AutoscaleStrategy.CLAHE):
        return create_synthetic_rgb_suppressed(band1, band2)
    return create_synthetic_rgb_by_mode(mode, band1, band2)
