"""Tests: resize dimension math, padding, Lanczos3 convolution vs Pillow."""
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

import oracle
from sarpro_tpu.core import resize
from sarpro_tpu.types import BitDepth


def test_calculate_resize_dimensions():
    # landscape / portrait / upscale-noop (reference: resize.rs:6-30)
    assert resize.calculate_resize_dimensions(4000, 2000, 1000) == (1000, 500)
    assert resize.calculate_resize_dimensions(2000, 4000, 1000) == (500, 1000)
    assert resize.calculate_resize_dimensions(800, 600, 1000) == (800, 600)
    assert resize.calculate_resize_dimensions(3000, 2000, 1024) == (1024, 683)


def test_padding_matches_oracle(rng):
    arr = rng.integers(0, 255, (30, 50)).astype(np.uint8)
    p8, _ = resize.add_padding_to_square(arr, None, 50, 30, BitDepth.U8)
    np.testing.assert_array_equal(np.asarray(p8), oracle.pad_to_square(arr))

    arr16 = rng.integers(0, 65535, (50, 30)).astype(np.uint16)
    _, p16 = resize.add_padding_to_square(None, arr16, 30, 50, BitDepth.U16)
    np.testing.assert_array_equal(np.asarray(p16), oracle.pad_to_square(arr16))


@pytest.mark.parametrize("shape,target", [((128, 96), (64, 48)), ((100, 80), (37, 30))])
def test_lanczos3_u8_vs_pillow(rng, shape, target):
    """Pillow LANCZOS uses the same convolution bounds/normalization that
    fast_image_resize ports — outputs should agree within fixed-point noise."""
    img = rng.integers(0, 256, shape).astype(np.uint8)
    got = np.asarray(
        resize.resize_u8_image(img, shape[1], shape[0], target[1], target[0])
    )
    want = np.asarray(
        Image.fromarray(img).resize((target[1], target[0]), Image.LANCZOS)
    )
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()}"
    assert (diff == 0).mean() > 0.95


def test_lanczos3_u16(rng):
    """u16 path: two passes through a u16 intermediate (matching
    fast_image_resize's U16 pipeline). Compare against the single-pass float
    reference within per-pass rounding."""
    img = rng.integers(0, 65536, (64, 64)).astype(np.uint16)
    got = np.asarray(resize.resize_u16_image(img, 64, 64, 32, 32))
    # f64 oracle of the same two-pass pipeline (horizontal, clamp to u16,
    # vertical, clamp) — the clamps matter: Lanczos ringing clipped per pass
    s, w = (np.asarray(a) for a in resize._build_coeffs(64, 32, "lanczos3"))

    def conv0(x):
        idx = np.clip(s[:, None] + np.arange(w.shape[1]), 0, x.shape[0] - 1)
        return np.einsum("ok,okc->oc", w.astype(np.float64), x[idx])

    mid = np.clip(np.floor(conv0(img.astype(np.float64).T).T + 0.5), 0, 65535)
    want = np.clip(np.floor(conv0(mid) + 0.5), 0, 65535).astype(np.uint16)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 2  # f32-vs-f64 rounding, one step per pass
    assert (diff <= 1).mean() > 0.99


def test_identity_resample(rng):
    img = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    got = np.asarray(resize.resize_u8_image(img, 32, 32, 32, 32))
    np.testing.assert_array_equal(got, img)


def test_resize_image_data_with_meta_skip_and_pad(rng):
    img = rng.integers(0, 255, (40, 60)).astype(np.uint8)
    # already at target long side -> skip resize, pad to square
    (fc, fr, u8, u16, sx, sy, pl, pt) = resize.resize_image_data_with_meta(
        img, None, 60, 40, 60, BitDepth.U8, pad=True
    )
    assert (fc, fr) == (60, 60) and (sx, sy) == (1.0, 1.0)
    assert (pl, pt) == (0, 10)
    np.testing.assert_array_equal(np.asarray(u8), oracle.pad_to_square(img))

    # actual resize with meta
    (fc, fr, u8, u16, sx, sy, pl, pt) = resize.resize_image_data_with_meta(
        img, None, 60, 40, 30, BitDepth.U8, pad=False
    )
    assert (fc, fr) == (30, 20)
    assert sx == pytest.approx(0.5) and sy == pytest.approx(0.5)
    assert (pl, pt) == (0, 0)


def test_resample_filters_smoke(rng):
    """All reader-path filters produce sane output (downsample-on-read,
    reference: gdal.rs:145-177 + sentinel1.rs:1089-1102)."""
    x = rng.lognormal(5, 1, (100, 80)).astype(np.float32)
    for f in ("nearest", "bilinear", "cubic", "lanczos", "average"):
        y = np.asarray(resize.resample_plane(x, 25, 20, f))
        assert y.shape == (25, 20)
        assert np.isfinite(y).all()
        # means should be preserved approximately by averaging filters
        if f in ("average", "bilinear"):
            assert abs(y.mean() - x.mean()) / x.mean() < 0.05


def test_large_reduction_contraction_asks_for_full_f32():
    """Past _TAP_LOOP_MAX taps the resampler contracts a gathered window
    with one dot_general; on the GPU a default-precision f32 dot may run in
    TF32 (~3 decimal digits), so it must ask for HIGHEST."""
    import jax

    s, w = resize._build_coeffs(400, 20, "lanczos")
    assert w.shape[1] > resize._TAP_LOOP_MAX
    jaxpr = jax.make_jaxpr(resize._resample_axis0)(
        jnp.zeros((400, 8), jnp.uint16), jnp.asarray(s), jnp.asarray(w))
    dots = [e for e in jaxpr.jaxpr.eqns[0].params["jaxpr"].eqns
            if e.primitive.name == "dot_general"]
    assert dots, "large reductions contract with dot_general"
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec


@pytest.mark.parametrize("filt,in_n,out_n", [
    ("lanczos", 4000, 205),   # 400 MP -> 1024-style reduction: 119 taps
    ("lanczos", 1600, 160),
    ("average", 3000, 100),
])
def test_large_reduction_matches_f64_oracle(rng, filt, in_n, out_n):
    """The einsum path (lanczos 20000 -> 1024 ratio) against an f64 numpy
    evaluation of the same normalized Pillow-convention weights."""
    s, w = resize._build_coeffs(in_n, out_n, filt)
    assert w.shape[1] > resize._TAP_LOOP_MAX
    x = rng.integers(0, 65535, (in_n, 24)).astype(np.uint16)
    got = np.asarray(resize._apply_axis0(jnp.asarray(x), filt, in_n, out_n))
    idx = np.clip(s[:, None].astype(np.int64) + np.arange(w.shape[1]), 0,
                  in_n - 1)
    want = np.einsum("ok,okc->oc", w.astype(np.float64),
                     x[idx].astype(np.float64))
    assert got.dtype == np.float32 and got.shape == (out_n, 24)
    # f32 accumulation of ~100 taps of u16-sized terms: relative 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.05)


@pytest.mark.gpu
def test_large_reduction_on_card_is_full_f32(gpu, rng):
    """On the card a TF32 contraction would miss the f64 oracle by ~1e-3;
    the HIGHEST einsum must hold the f32 tolerance."""
    in_n, out_n = 4000, 205
    s, w = resize._build_coeffs(in_n, out_n, "lanczos")
    x = rng.integers(0, 65535, (in_n, 256)).astype(np.uint16)
    got = np.asarray(resize._apply_axis0(jnp.asarray(x), "lanczos", in_n,
                                         out_n))
    idx = np.clip(s[:, None].astype(np.int64) + np.arange(w.shape[1]), 0,
                  in_n - 1)
    want = np.einsum("ok,okc->oc", w.astype(np.float64),
                     x[idx].astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.05)
