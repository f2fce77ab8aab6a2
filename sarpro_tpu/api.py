"""High-level library API (reference: src/api/mod.rs).

Process SAFE to files or in-memory buffers, batch helpers for directories,
typed save/load helpers. Mirrors the exact public surface re-exported at the
reference crate root (src/lib.rs:217-240): `process_safe_to_path`,
`process_safe_to_buffer[_with_mode]`, `process_directory_to_path`,
`process_safe_with_options`, `save_image`, `save_multiband_image`,
`load_polarization`, `load_operation`, `ProcessedImage`, `BatchReport`.
"""
from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from .core.pipeline import process_scalar_data_pipeline
from .core.resize import resize_image_data
from .core.save import (
    save_processed_image,
    save_processed_multiband_image_sequential,
)
from .core.synthetic_rgb import create_synthetic_rgb_by_mode_and_strategy
from .errors import ProcessingError
from .io.safe import SafeMetadata, SafeReader, TargetCrsArg
from .params import ProcessingParams
from .types import (
    AutoscaleStrategy,
    BitDepth,
    BitDepthArg,
    OutputFormat,
    Polarization,
    PolarizationOperation,
    ProcessingOperation,
    SyntheticRgbMode,
)

logger = logging.getLogger("sarpro")

_OP_STR = {
    PolarizationOperation.SUM: "sum",
    PolarizationOperation.DIFF: "difference",
    PolarizationOperation.RATIO: "ratio",
    PolarizationOperation.NDIFF: "normalized_diff",
    PolarizationOperation.LOG_RATIO: "log_ratio",
}


def _pol_to_reader_hint(pol: Polarization) -> Optional[str]:
    """reference: api/mod.rs:39-47."""
    if pol.kind in ("vv", "vh", "hh", "hv"):
        return pol.kind
    return "all_pairs"  # multiband and operations


def _resolve_target_args(params: ProcessingParams):
    """Map target CRS strings none/auto/custom and resample names
    (reference: api/mod.rs:544-557, lanczos default)."""
    t = params.target_crs
    if t is None:
        target_arg = None
    elif t.lower() == "none":
        target_arg = TargetCrsArg.NONE
    elif t.lower() == "auto":
        target_arg = TargetCrsArg.AUTO
    else:
        target_arg = t
    alg = params.resample_alg
    if alg in ("nearest", "bilinear", "cubic", "lanczos"):
        resample = alg
    elif alg is None:
        # unspecified → reader heuristic (Average for ≥4× reductions), the
        # reference *CLI* semantics (runner.rs:61-67). ProcessingParams's
        # default is "lanczos" (params.rs:38), so default params still match
        # the reference API's lanczos default.
        resample = None
    else:  # unknown name → lanczos (api/mod.rs:556)
        resample = "lanczos"
    return target_arg, resample


def _band_pair(reader: SafeReader, what: str):
    """Prefer VV/VH, else HH/HV (reference: api/mod.rs:133-143 et al.)."""
    if reader.has_vv() and reader.has_vh():
        return reader.vv_data(), reader.vh_data(), True
    if reader.has_hh() and reader.has_hv():
        return reader.hh_data(), reader.hv_data(), False
    raise ProcessingError(
        f"{what} requires VV+VH or HH+HV; available: "
        f"{reader.get_available_polarizations()}"
    )


def _op_band(reader: SafeReader, op: PolarizationOperation):
    if reader.has_vv() and reader.has_vh():
        return {
            PolarizationOperation.SUM: reader.sum_data,
            PolarizationOperation.DIFF: reader.difference_data,
            PolarizationOperation.RATIO: reader.ratio_data,
            PolarizationOperation.NDIFF: reader.normalized_diff_data,
            PolarizationOperation.LOG_RATIO: reader.log_ratio_data,
        }[op]()
    if reader.has_hh() and reader.has_hv():
        return {
            PolarizationOperation.SUM: reader.sum_hh_hv_data,
            PolarizationOperation.DIFF: reader.difference_hh_hv_data,
            PolarizationOperation.RATIO: reader.ratio_hh_hv_data,
            PolarizationOperation.NDIFF: reader.normalized_diff_hh_hv_data,
            PolarizationOperation.LOG_RATIO: reader.log_ratio_hh_hv_data,
        }[op]()
    raise ProcessingError(
        f"Operation {_OP_STR[op]} requires VV+VH or HH+HV; available: "
        f"{reader.get_available_polarizations()}"
    )


def _single_band(reader: SafeReader, pol: Polarization):
    return {
        "vv": reader.vv_data, "vh": reader.vh_data,
        "hh": reader.hh_data, "hv": reader.hv_data,
    }[pol.kind]()


@dataclasses.dataclass
class ProcessedImage:
    """Result of in-memory processing (reference: api/mod.rs:51-62)."""

    width: int
    height: int
    bit_depth: BitDepth
    format: OutputFormat
    gray: Optional[np.ndarray] = None          # single-band U8
    gray16: Optional[np.ndarray] = None        # single-band U16
    rgb: Optional[np.ndarray] = None           # interleaved RGB
    gray_band2: Optional[np.ndarray] = None    # multiband second band U8
    gray16_band2: Optional[np.ndarray] = None  # multiband second band U16
    metadata: Optional[SafeMetadata] = None


@dataclasses.dataclass
class BatchReport:
    """reference: api/mod.rs:452-457."""

    processed: int = 0
    skipped: int = 0
    errors: int = 0


def process_safe_to_buffer(
    input,
    polarization: Polarization,
    autoscale: AutoscaleStrategy,
    bit_depth: BitDepth,
    target_size: Optional[int] = None,
    pad: bool = False,
    output_format: OutputFormat = OutputFormat.TIFF,
) -> ProcessedImage:
    """In-memory processing, no disk output (reference: api/mod.rs:65-371).
    The buffer path never warps (reader opened without target CRS)."""
    return process_safe_to_buffer_with_mode(
        input, polarization, autoscale, bit_depth, target_size, pad,
        output_format, SyntheticRgbMode.DEFAULT,
    )


def process_safe_to_buffer_with_mode(
    input,
    polarization: Polarization,
    autoscale: AutoscaleStrategy,
    bit_depth: BitDepth,
    target_size: Optional[int] = None,
    pad: bool = False,
    output_format: OutputFormat = OutputFormat.TIFF,
    synrgb_mode: SyntheticRgbMode = SyntheticRgbMode.DEFAULT,
) -> ProcessedImage:
    """reference: api/mod.rs:374-449."""
    reader = SafeReader.open_with_options(
        input, _pol_to_reader_hint(polarization), None, None, target_size
    )

    def run_single(band, fmt: OutputFormat, depth: BitDepth) -> ProcessedImage:
        res = process_scalar_data_pipeline(band, depth, autoscale)
        rows, cols = res.shape
        fc, fr, f8, f16 = resize_image_data(
            res.scaled_u8, res.scaled_u16, cols, rows, target_size, depth, pad
        )
        return ProcessedImage(
            width=fc, height=fr, bit_depth=depth, format=fmt,
            gray=np.asarray(f8) if depth is BitDepth.U8 else None,
            gray16=np.asarray(f16) if depth is BitDepth.U16 else None,
            metadata=reader.metadata.copy(),
        )

    if polarization.kind in ("vv", "vh", "hh", "hv"):
        band = _single_band(reader, polarization)
        if output_format is OutputFormat.TIFF:
            return run_single(band, OutputFormat.TIFF, bit_depth)
        return run_single(band, OutputFormat.JPEG, BitDepth.U8)

    if polarization.kind == "multiband":
        band1, band2, _vvvh = _band_pair(reader, "Multiband")
        if output_format is OutputFormat.TIFF:
            res1 = process_scalar_data_pipeline(band1, bit_depth, autoscale)
            rows, cols = res1.shape
            fc, fr, f1_8, f1_16 = resize_image_data(
                res1.scaled_u8, res1.scaled_u16, cols, rows, target_size, bit_depth, pad
            )
            res2 = process_scalar_data_pipeline(band2, bit_depth, autoscale)
            _c, _r, f2_8, f2_16 = resize_image_data(
                res2.scaled_u8, res2.scaled_u16, cols, rows, target_size, bit_depth, pad
            )
            is8 = bit_depth is BitDepth.U8
            return ProcessedImage(
                width=fc, height=fr, bit_depth=bit_depth, format=OutputFormat.TIFF,
                gray=np.asarray(f1_8) if is8 else None,
                gray16=np.asarray(f1_16) if not is8 else None,
                gray_band2=np.asarray(f2_8) if is8 else None,
                gray16_band2=np.asarray(f2_16) if not is8 else None,
                metadata=reader.metadata.copy(),
            )
        # JPEG multiband → synthetic RGB (api/mod.rs:203-247, :394-438)
        res1 = process_scalar_data_pipeline(band1, BitDepth.U8, autoscale)
        rows, cols = res1.shape
        fc, fr, f1_8, _ = resize_image_data(
            res1.scaled_u8, None, cols, rows, target_size, BitDepth.U8, pad
        )
        res2 = process_scalar_data_pipeline(band2, BitDepth.U8, autoscale)
        _c, _r, f2_8, _ = resize_image_data(
            res2.scaled_u8, None, cols, rows, target_size, BitDepth.U8, pad
        )
        rgb = create_synthetic_rgb_by_mode_and_strategy(synrgb_mode, autoscale, f1_8, f2_8)
        return ProcessedImage(
            width=fc, height=fr, bit_depth=BitDepth.U8, format=OutputFormat.JPEG,
            rgb=np.asarray(rgb), metadata=reader.metadata.copy(),
        )

    # Polarization operation → single-band path (api/mod.rs:284-369)
    combined = _op_band(reader, polarization.op)
    if output_format is OutputFormat.TIFF:
        return run_single(combined, OutputFormat.TIFF, bit_depth)
    return run_single(combined, OutputFormat.JPEG, BitDepth.U8)


def iterate_safe_products(input_dir):
    """Immediate subdirectories of input_dir (reference: api/mod.rs:460-470)."""
    return iter(sorted(p for p in Path(input_dir).iterdir() if p.is_dir()))


def scene_skip_reason(path, params: ProcessingParams) -> Optional[str]:
    """Cheap (metadata-only) viability check for batch mode.

    Mirrors the reference's warnings-mode reader skip semantics
    (sentinel1.rs:592-796 via api/mod.rs:502-533): unsupported product type,
    missing requested polarization files, and unsatisfiable band pairs all
    return a skip reason instead of becoming errors. Unlike the reference we
    do NOT load the raster data twice (known inefficiency, api/mod.rs:502-518)
    — the check reads XML only.

    Returns None when the product is viable, else a human-readable reason.
    """
    from .io.safe import identify_polarization_files, parse_comprehensive_metadata

    path = Path(path)
    if not (path / "annotation").is_dir() or not (path / "measurement").is_dir():
        return "missing annotation/measurement directory"
    meta = parse_comprehensive_metadata(path)
    if meta.product_type.upper() != "GRD":
        return f"unsupported product type: {meta.product_type}"
    vv, vh, hh, hv = identify_polarization_files(
        path / "measurement", meta.polarizations
    )
    kind = params.polarization.kind
    if kind in ("vv", "vh", "hh", "hv"):
        if {"vv": vv, "vh": vh, "hh": hh, "hv": hv}[kind] is None:
            return f"{kind.upper()} measurement file not found"
        return None
    # multiband and polarization ops need a co/cross pair (api.py:_band_pair)
    if (vv is not None and vh is not None) or (hh is not None and hv is not None):
        return None
    return "no usable polarization pair (need VV+VH or HH+HV)"


def process_directory_to_path(
    input_dir, output_dir, params: ProcessingParams,
    continue_on_error: bool = True, fast: bool = False, resume: bool = False,
    progress=None, shard_devices: int = 0,
) -> BatchReport:
    """Batch all SAFE subdirectories (reference: api/mod.rs:474-536).

    `progress(done, total, current_name)` (optional) is called as scenes
    finish — the GUI's live batch progress hook.

    Note: the reference opens each product twice (viability check + process,
    api/mod.rs:502-518) — a known inefficiency deliberately NOT replicated;
    we run the viability check cheaply on metadata only."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    report = BatchReport()
    target_arg, resample = _resolve_target_args(params)
    products = list(iterate_safe_products(input_dir))

    def tick(current=None):
        if progress is not None:
            try:
                progress(report.processed + report.skipped + report.errors,
                         len(products), current)
            except Exception:  # noqa: BLE001 — observer must not break batch
                pass

    for path in products:
        tick(path.name)
        # viability: parse metadata + check product type / pol availability
        # (reference: api/mod.rs:502-533 — skip, don't error)
        try:
            reason = scene_skip_reason(path, params)
        except Exception:
            reason = "unreadable product metadata"
        if reason is not None:
            logger.warning("Skipping %s: %s", path, reason)
            report.skipped += 1
            tick()
            continue
        ext = params.format.extension
        output_path = output_dir / f"{path.name}.{ext}"
        if resume and output_path.exists():
            logger.info("Resume: output exists, skipping %s", path)
            report.skipped += 1
            tick()
            continue
        try:
            process_safe_to_path(path, output_path, params, fast=fast,
                                 shard_devices=shard_devices)
            report.processed += 1
        except Exception as e:
            logger.warning("Error processing %s: %s", path, e)
            report.errors += 1
            if not continue_on_error:
                raise
        tick()
    return report


def process_safe_to_path(input, output, params: ProcessingParams,
                         fast: bool = False, shard_devices: int = 0) -> None:
    """File-output pipeline driven by ProcessingParams (reference: api/mod.rs:539-674).

    fast=True routes the compute through the fused single-program pipeline
    (core/fused.py — the benchmark path): one device dispatch per band,
    within ≤1 histogram bin of the exact mode's window placement.
    shard_devices>=2 (or -1 for all local devices) additionally shards the
    scene's rows across a device mesh — stats become cross-device collectives
    (SURVEY §2.5's intra-scene TP/SP analogue); implies fast mode."""
    if fast or shard_devices:
        return _process_safe_to_path_fast(input, output, params,
                                          shard_devices=shard_devices)
    if params.size is None:
        # full-resolution exact mode materializes whole-raster intermediates
        # on device; past the single-program HBM budget route through the
        # streamed fast-mode path instead of OOMing (semantics within ≤1
        # histogram bin; reference CPU handles these scenes in 40-70 s)
        from .core.streamed import BIG_SCENE_PIXELS
        from .io.safe import parse_comprehensive_metadata

        try:
            meta = parse_comprehensive_metadata(Path(input))
            big = 0 < meta.lines * meta.samples > BIG_SCENE_PIXELS
        except Exception:  # noqa: BLE001 — fall through to the normal path
            big = False
        if big:
            logger.warning(
                "scene %dx%d exceeds the exact-mode device budget; using the "
                "streamed fast-mode pipeline (≤1 histogram bin difference)",
                meta.samples, meta.lines)
            return _process_safe_to_path_fast(input, output, params)
    bit_depth = params.bit_depth.to_bit_depth()
    target_arg, resample = _resolve_target_args(params)
    reader = SafeReader.open_with_options(
        input, _pol_to_reader_hint(params.polarization), target_arg, resample,
        params.size,
    )
    pol = params.polarization
    if pol.kind in ("vv", "vh", "hh", "hv"):
        processed = _single_band(reader, pol)
        save_processed_image(
            processed, output, params.format, bit_depth, params.size,
            reader.metadata, params.pad, params.autoscale,
            ProcessingOperation.SINGLE_BAND,
        )
    elif pol.kind == "multiband":
        band1, band2, is_vvvh = _band_pair(reader, "Multiband")
        save_processed_multiband_image_sequential(
            band1, band2, output, params.format, bit_depth, params.size,
            reader.metadata, params.pad, params.autoscale,
            ProcessingOperation.MULTIBAND_VV_VH if is_vvvh
            else ProcessingOperation.MULTIBAND_HH_HV,
            params.synrgb_mode,
        )
    else:
        processed = _op_band(reader, pol.op)
        save_processed_image(
            processed, output, params.format, bit_depth, params.size,
            reader.metadata, params.pad, params.autoscale,
            ProcessingOperation.PolarOp(pol.op),
        )


def _process_safe_to_path_fast(input, output, params: ProcessingParams,
                               shard_devices: int = 0) -> None:
    """Fast mode: downsample-on-read in the reader, everything else in one
    XLA program.

    The reader applies downsample-on-read (Average reductions stream through
    the native single-pass host box reduce — one touch of the source bytes,
    ~100x less host→device traffic; mild/Lanczos reductions resample on
    device), so the fused program's in-graph resample no-ops on the
    already-at-size raster. Warps run in the reader too (already at target
    size when `size` is set, matching the reference's single-pass `-ts`
    warp)."""
    from .core import fast_path

    bit_depth = params.bit_depth.to_bit_depth()
    target_arg, resample = _resolve_target_args(params)
    warping = params.target_crs is not None and params.target_crs.lower() != "none"
    size = params.size
    pol = params.polarization
    alg0 = None if warping else resample  # warp already consumed the filter

    band_stage = None
    if (pol.kind == "multiband" and params.format is OutputFormat.JPEG
            and not shard_devices):
        # overlapped pair load: band 1's device program (resample → dB/stats
        # → autoscale → u8 [+pad]) dispatches while band 2 streams off disk;
        # the combine program below consumes the resident result. Big scenes
        # route through the streamed path instead — skip staging for them.
        from .core.fast_path import _is_big_scene

        def band_stage(dn1):
            from .core import fused

            if _is_big_scene(*dn1.shape, size):
                return None
            return fused.synrgb_band_stage(
                dn1, strategy=params.autoscale, copol=True, target_size=size,
                pad=params.pad, resample_alg=alg0)

    # the warp executes inside the reader open; request row sharding of its
    # sampling pass over the device mesh (the
    # reference's headline config is warp + synRGB). Setting the var to 0
    # (its default) when not sharding keeps one open call.
    from .io import warp as warp_mod

    token = warp_mod.SHARD_DEVICES.set(shard_devices if warping else 0)
    try:
        reader = SafeReader.open_with_options(
            input, _pol_to_reader_hint(params.polarization), target_arg,
            resample, params.size, band_stage=band_stage,
        )
    finally:
        warp_mod.SHARD_DEVICES.reset(token)
    alg = alg0
    if pol.kind in ("vv", "vh", "hh", "hv"):
        fast_path.save_single_band_fast(
            _single_band(reader, pol), output, params.format, bit_depth, size,
            reader.metadata, params.pad, params.autoscale,
            ProcessingOperation.SINGLE_BAND, resample_alg=alg,
            shard_devices=shard_devices,
        )
    elif pol.kind == "multiband":
        band1, band2, is_vvvh = _band_pair(reader, "Multiband")
        fast_path.save_multiband_fast(
            band1, band2, output, params.format, bit_depth, size,
            reader.metadata, params.pad, params.autoscale,
            ProcessingOperation.MULTIBAND_VV_VH if is_vvvh
            else ProcessingOperation.MULTIBAND_HH_HV,
            params.synrgb_mode, resample_alg=alg,
            staged_b1=reader.staged_band1,
            shard_devices=shard_devices,
        )
    else:
        fast_path.save_single_band_fast(
            _op_band(reader, pol.op), output, params.format, bit_depth, size,
            reader.metadata, params.pad, params.autoscale,
            ProcessingOperation.PolarOp(pol.op), resample_alg=alg,
            shard_devices=shard_devices,
        )


def process_safe_with_options(
    input, output,
    format: OutputFormat, bit_depth: BitDepth, polarization: Polarization,
    autoscale: AutoscaleStrategy, size: Optional[int] = None, pad: bool = False,
) -> None:
    """Typed convenience variant (reference: api/mod.rs:677-800)."""
    params = ProcessingParams(
        format=format,
        bit_depth=BitDepthArg.U8 if bit_depth is BitDepth.U8 else BitDepthArg.U16,
        polarization=polarization,
        autoscale=autoscale,
        size=size,
        pad=pad,
        target_crs=None,
        resample_alg=None,
        synrgb_mode=SyntheticRgbMode.DEFAULT,
    )
    process_safe_to_path(input, output, params)


def save_image(
    processed, output, format: OutputFormat, bit_depth: BitDepth,
    target_size: Optional[int] = None, metadata: Optional[SafeMetadata] = None,
    pad: bool = False,
    autoscale: AutoscaleStrategy = AutoscaleStrategy.STANDARD,
    operation: ProcessingOperation = ProcessingOperation.SINGLE_BAND,
) -> None:
    """Typed save helper for single-band arrays (reference: api/mod.rs:803-826)."""
    save_processed_image(
        processed, output, format, bit_depth, target_size, metadata, pad,
        autoscale, operation,
    )


def save_multiband_image(
    processed1, processed2, output, format: OutputFormat, bit_depth: BitDepth,
    target_size: Optional[int] = None, metadata: Optional[SafeMetadata] = None,
    pad: bool = False,
    autoscale: AutoscaleStrategy = AutoscaleStrategy.STANDARD,
    operation: ProcessingOperation = ProcessingOperation.MULTIBAND_VV_VH,
) -> None:
    """Typed save helper for multiband arrays (reference: api/mod.rs:829-856)."""
    save_processed_multiband_image_sequential(
        processed1, processed2, output, format, bit_depth, target_size,
        metadata, pad, autoscale, operation, SyntheticRgbMode.DEFAULT,
    )


def load_polarization(input, pol: Polarization):
    """Load one polarization's intensity array + metadata
    (reference: api/mod.rs:859-881)."""
    if pol.kind in ("multiband", "op"):
        raise ProcessingError(
            "load_polarization expects a single polarization (vv/vh/hh/hv)"
        )
    reader = SafeReader.open_with_options(input, _pol_to_reader_hint(pol), None, None, None)
    data = _single_band(reader, pol)
    return data, reader.metadata.copy()


def load_operation(input, op: PolarizationOperation):
    """Compute an operation over an available pair (reference: api/mod.rs:884-916)."""
    reader = SafeReader.open_with_options(input, "all_pairs", None, None, None)
    data = _op_band(reader, op)
    return data, reader.metadata.copy()
