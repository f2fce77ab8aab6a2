"""sarpro_tpu — a Sentinel-1 GRD processing framework on JAX/XLA.

A ground-up JAX/XLA re-architecture with the full capability surface
of the SARPRO reference (bogwi/sarpro v0.3.0): SAFE → GeoTIFF/JPEG conversion
with SAR-specific autoscaling (standard/robust/adaptive/equalized/CLAHE/
tamed), dual-pol operations, synthetic RGB composition, resize/pad, on-device
reprojection, metadata embedding and sidecars, a typed library API, a CLI,
and batch processing — with the dense per-pixel compute chain running as
fused XLA programs on an NVIDIA GPU (or the CPU backend).

Public API mirrors the reference's crate root re-exports (src/lib.rs:217-240).
"""

__version__ = "0.5.0"

from .types import (  # noqa: F401,E402
    AutoscaleStrategy,
    BitDepth,
    BitDepthArg,
    InputFormat,
    OutputFormat,
    Polarization,
    PolarizationOperation,
    ProcessingOperation,
    SyntheticRgbMode,
)
from .errors import (  # noqa: F401,E402
    ExternalError,
    IncompleteDataPair,
    InvalidArgument,
    MissingArgument,
    ProcessingError,
    SarproError,
    ZeroSize,
)
from .params import ProcessingParams  # noqa: F401,E402


def __getattr__(name):
    # Lazy heavyweight imports (pull in jax) — keep `import sarpro_tpu` fast.
    _api_names = {
        "ProcessedImage", "BatchReport", "process_safe_to_path",
        "process_safe_to_buffer", "process_safe_to_buffer_with_mode",
        "process_directory_to_path", "process_safe_with_options",
        "iterate_safe_products", "save_image", "save_multiband_image",
        "load_polarization", "load_operation",
    }
    if name in _api_names:
        from . import api

        return getattr(api, name)
    if name in ("SafeReader", "SafeMetadata", "TargetCrsArg"):
        from . import io

        return getattr(io, name)
    # reader/writer helpers re-exported at the crate root in the reference
    # (src/lib.rs:227-234)
    if name in ("RasterReader", "RasterMetadata"):
        from .io import raster

        return getattr(raster, name)
    if name in ("create_jpeg_metadata_sidecar", "embed_tiff_metadata",
                "extract_metadata_fields"):
        from .io.writers import metadata as _md

        return getattr(_md, name)
    if name in ("SafeError", "RasterError", "UnsupportedProduct"):
        from . import errors as _errors

        return getattr(_errors, name)
    raise AttributeError(f"module 'sarpro_tpu' has no attribute {name!r}")
