"""JPEG writers at quality 100 (reference: src/io/writers/jpeg.rs:6-30).

The reference hardcodes quality 100 (jpeg.rs:14,27) — deliberately preserved.
4:4:4 subsampling matches the jpeg-encoder crate's behavior at quality >= 90
(no chroma loss).

Encoders, fastest-first: the framework's own native encoder
(native/jpegenc.cpp — the self-contained analogue of the reference's
jpeg-encoder crate) consuming either quantized DCT coefficient blocks the
fused device program computes in-graph (the JPEG front-end on the device;
host pays entropy coding only) or planar YCbCr u8; then OpenCV's
libjpeg-turbo binding; then Pillow (imported only when used). All produce
baseline q100 4:4:4 streams.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ... import _native

try:
    import cv2

    _CV2_FLAGS = [int(cv2.IMWRITE_JPEG_QUALITY), 100,
                  int(cv2.IMWRITE_JPEG_SAMPLING_FACTOR),
                  int(cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)]
except ImportError:  # pragma: no cover — cv2 is present in the target env
    cv2 = None

JPEG_QUALITY = 100


def write_gray_jpeg(output, cols: int, rows: int, data) -> None:
    """reference: jpeg.rs:6-17."""
    arr = np.asarray(data).reshape(rows, cols).astype(np.uint8, copy=False)
    if _native.available():
        Path(output).write_bytes(
            _native.jpeg_encode_gray(np.ascontiguousarray(arr)))
        return
    if cv2 is not None and Path(output).suffix.lower() in (".jpg", ".jpeg"):
        if cv2.imwrite(str(output), arr, _CV2_FLAGS):
            return
    from PIL import Image

    Image.fromarray(arr, mode="L").save(
        Path(output), format="JPEG", quality=JPEG_QUALITY, subsampling=0
    )


def write_gray_jpeg_dct(output, cols: int, rows: int, coeffs) -> None:
    """Grayscale q100 JPEG from the device JPEG front-end's quantized
    coefficient blocks ((bh,bw,8,8) int16) — entropy-only host encode."""
    blob = _native.jpeg_encode_coeffs_gray(np.asarray(coeffs), cols, rows)
    Path(output).write_bytes(blob)


def write_rgb_jpeg(output, cols: int, rows: int, rgb_data,
                   channel_order: str = "rgb") -> None:
    """reference: jpeg.rs:19-30 (interleaved RGB).

    `channel_order="bgr"` accepts BGR-interleaved input (the fused device
    program emits BGR at zero cost for this writer), skipping the host-side
    channel swap entirely on the cv2 path."""
    arr = np.asarray(rgb_data).reshape(rows, cols, 3).astype(np.uint8, copy=False)
    if cv2 is not None and Path(output).suffix.lower() in (".jpg", ".jpeg"):
        # cv2 wants BGR; a strided reverse copy beats cv2.cvtColor's
        # allocate+convert
        bgr = arr if channel_order == "bgr" else np.ascontiguousarray(arr[..., ::-1])
        if cv2.imwrite(str(output), bgr, _CV2_FLAGS):
            return
    rgb = arr if channel_order == "rgb" else arr[..., ::-1]
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(rgb), mode="RGB").save(
        Path(output), format="JPEG", quality=JPEG_QUALITY, subsampling=0
    )


def preferred_synrgb_layout() -> str:
    """Fastest device→file layout for the fused fast path: 'dct' — the
    fused program emits quantized q100 DCT coefficient blocks (the JPEG
    front-end runs on the device) and the host pays entropy coding only —
    whenever the native encoder is built, else 'bgr' for cv2/Pillow."""
    return "dct" if _native.available() else "bgr"


def preferred_gray_layout() -> str:
    """Single-band JPEG: 'dct' (device JPEG front-end, entropy-only host)
    whenever the native encoder is built, 'u8' otherwise."""
    layout = preferred_synrgb_layout()
    return "dct" if layout == "dct" else "u8"


def write_synrgb_jpeg(output, cols: int, rows: int, arr,
                      layout: str = "rgb") -> None:
    """Write the fused program's synRGB output in whatever layout it was
    produced ('dct' quantized coefficient blocks (3,bh,bw,8,8) int16,
    'ycbcr' planar (3,rows,cols), 'bgr' or 'rgb' interleaved)."""
    if layout == "dct":
        co = np.asarray(arr)
        blob = _native.jpeg_encode_coeffs444(co[0], co[1], co[2], cols, rows)
        Path(output).write_bytes(blob)
        return
    if layout == "ycbcr":
        planes = np.asarray(arr).reshape(3, rows, cols)
        blob = _native.jpeg_encode_ycbcr444(
            np.ascontiguousarray(planes[0]),
            np.ascontiguousarray(planes[1]),
            np.ascontiguousarray(planes[2]),
        )
        Path(output).write_bytes(blob)
        return
    write_rgb_jpeg(output, cols, rows, arr, channel_order=layout)
