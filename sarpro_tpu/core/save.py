"""Save orchestration: pipeline → resize/pad → geotransform rescale → writers
(reference: src/core/processing/save.rs:23-406)."""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np

from ..io.writers.jpeg import write_gray_jpeg, write_rgb_jpeg
from ..io.writers.metadata import (
    create_jpeg_metadata_sidecar_with_overrides,
    create_jpeg_metadata_sidecar_with_overrides_and_extras,
    embed_tiff_metadata,
)
from ..io.writers.tiff import (
    write_tiff_multiband_u8,
    write_tiff_multiband_u16,
    write_tiff_u8,
    write_tiff_u16,
)
from ..io.writers.worldfile import write_prj_file, write_world_file
from ..types import (
    AutoscaleStrategy,
    BitDepth,
    OutputFormat,
    ProcessingOperation,
    SyntheticRgbMode,
)
from .pipeline import (
    autoscale_db_image_tamed_synrgb_u8,
    process_scalar_data_pipeline,
)
from .resize import resize_image_data_with_meta
from .synthetic_rgb import create_synthetic_rgb_by_mode_and_strategy

logger = logging.getLogger("sarpro")


def _rescale_geotransform(meta, cols, rows, final_cols, final_rows,
                          pad_left, pad_top, scale_x, scale_y):
    """Pixel-size rescale + padding origin shift (reference: save.rs:70-87).

    gt[1] *= cols/final_cols, gt[5] *= rows/final_rows, then origin shifted by
    -pad_left*gt[1] / -pad_top*gt[5]."""
    gt_override = None
    proj_override = None
    if meta is not None:
        if meta.geotransform is not None:
            gt = list(meta.geotransform)
            if scale_x > 0.0:
                gt[1] = gt[1] * (cols / final_cols)
            if scale_y > 0.0:
                gt[5] = gt[5] * (rows / final_rows)
            gt[0] = gt[0] - pad_left * gt[1]
            gt[3] = gt[3] - pad_top * gt[5]
            gt_override = gt
        if meta.projection:
            proj_override = meta.projection
    return gt_override, proj_override


def save_processed_image(
    processed,
    output,
    format: OutputFormat,
    bit_depth: BitDepth,
    target_size: Optional[int],
    metadata=None,
    pad: bool = False,
    strategy: AutoscaleStrategy = AutoscaleStrategy.STANDARD,
    operation: ProcessingOperation = ProcessingOperation.SINGLE_BAND,
) -> None:
    """Single-band save path (reference: save.rs:23-170)."""
    output = Path(output)
    operation_label = operation.metadata_label

    if format is OutputFormat.TIFF:
        res = process_scalar_data_pipeline(processed, bit_depth, strategy)
        rows, cols = res.shape
        (final_cols, final_rows, final_u8, final_u16,
         scale_x, scale_y, pad_left, pad_top) = resize_image_data_with_meta(
            res.scaled_u8, res.scaled_u16, cols, rows, target_size, bit_depth, pad,
        )
        gt_override, proj_override = _rescale_geotransform(
            metadata, cols, rows, final_cols, final_rows, pad_left, pad_top,
            scale_x, scale_y,
        )
        if bit_depth is BitDepth.U8:
            ds = write_tiff_u8(output, final_cols, final_rows, np.asarray(final_u8))
        else:
            ds = write_tiff_u16(output, final_cols, final_rows, np.asarray(final_u16))
        if metadata is not None:
            embed_tiff_metadata(ds, metadata, operation_label, gt_override, proj_override)
        ds.flush()
        logger.info("save_processed_image: %s TIFF saved with metadata",
                    "U8" if bit_depth is BitDepth.U8 else "U16")
    else:  # JPEG — always U8 (reference: save.rs:119-167)
        res = process_scalar_data_pipeline(processed, BitDepth.U8, strategy)
        rows, cols = res.shape
        (final_cols, final_rows, final_u8, _f16,
         scale_x, scale_y, pad_left, pad_top) = resize_image_data_with_meta(
            res.scaled_u8, None, cols, rows, target_size, BitDepth.U8, pad,
        )
        write_gray_jpeg(output, final_cols, final_rows, np.asarray(final_u8))
        if metadata is not None:
            gt_override, proj_override = _rescale_geotransform(
                metadata, cols, rows, final_cols, final_rows, pad_left, pad_top,
                scale_x, scale_y,
            )
            if gt_override is not None:
                write_world_file(output, gt_override)
            if proj_override is not None:
                write_prj_file(output, proj_override)
            create_jpeg_metadata_sidecar_with_overrides(
                output, metadata, operation_label, gt_override, proj_override,
            )
        logger.info("save_processed_image: JPEG saved with metadata sidecar")


def save_processed_multiband_image_sequential(
    processed1,
    processed2,
    output,
    format: OutputFormat,
    bit_depth: BitDepth,
    target_size: Optional[int],
    metadata=None,
    pad: bool = False,
    strategy: AutoscaleStrategy = AutoscaleStrategy.STANDARD,
    operation: ProcessingOperation = ProcessingOperation.MULTIBAND_VV_VH,
    syn_mode: SyntheticRgbMode = SyntheticRgbMode.DEFAULT,
) -> None:
    """Two-band save with sequential band staging to bound peak memory
    (reference: save.rs:172-406). Band 1's intermediates are released before
    band 2 is processed — same discipline as the reference's explicit drops
    (save.rs:239-255), which keeps only one full-res dB raster in device memory
    at a time."""
    output = Path(output)
    operation_label = operation.metadata_label

    if format is OutputFormat.TIFF:
        res1 = process_scalar_data_pipeline(processed1, bit_depth, strategy)
        rows, cols = res1.shape
        (final_cols, final_rows, final_u8, final_u16,
         scale_x, scale_y, pad_left, pad_top) = resize_image_data_with_meta(
            res1.scaled_u8, res1.scaled_u16, cols, rows, target_size, bit_depth, pad,
        )
        gt_override, proj_override = _rescale_geotransform(
            metadata, cols, rows, final_cols, final_rows, pad_left, pad_top,
            scale_x, scale_y,
        )
        band1 = np.asarray(final_u8 if bit_depth is BitDepth.U8 else final_u16)
        del res1, final_u8, final_u16  # sequential staging (save.rs:239-241)

        res2 = process_scalar_data_pipeline(processed2, bit_depth, strategy)
        (_c2, _r2, f2_u8, f2_u16, _sx2, _sy2, _pl2, _pt2) = resize_image_data_with_meta(
            res2.scaled_u8, res2.scaled_u16, cols, rows, target_size, bit_depth, pad,
        )
        band2 = np.asarray(f2_u8 if bit_depth is BitDepth.U8 else f2_u16)

        if bit_depth is BitDepth.U8:
            ds = write_tiff_multiband_u8(output, final_cols, final_rows, band1, band2)
        else:
            ds = write_tiff_multiband_u16(output, final_cols, final_rows, band1, band2)
        if metadata is not None:
            embed_tiff_metadata(ds, metadata, operation_label, gt_override, proj_override)
        ds.flush()
        logger.info(
            "save_processed_multiband_image_sequential: %s TIFF saved with 2 bands",
            "U8" if bit_depth is BitDepth.U8 else "U16",
        )
    else:  # JPEG → synthetic RGB (reference: save.rs:317-403)
        logger.info("Creating synthetic RGB JPEG from VV|HH (R) and VH|HV (G) bands")
        res1 = process_scalar_data_pipeline(processed1, BitDepth.U8, strategy)
        # Tamed recomputes each band with the band-specific window
        # (reference: save.rs:324-328)
        if strategy is AutoscaleStrategy.TAMED:
            input_u8_band1 = autoscale_db_image_tamed_synrgb_u8(
                res1.db, res1.mask, res1.stats, is_copol=True
            )
        else:
            input_u8_band1 = res1.scaled_u8
        rows, cols = res1.shape
        (final_cols, final_rows, final_u8_band1, _f16,
         scale_x, scale_y, pad_left, pad_top) = resize_image_data_with_meta(
            input_u8_band1, None, cols, rows, target_size, BitDepth.U8, pad,
        )
        del res1, input_u8_band1

        res2 = process_scalar_data_pipeline(processed2, BitDepth.U8, strategy)
        if strategy is AutoscaleStrategy.TAMED:
            input_u8_band2 = autoscale_db_image_tamed_synrgb_u8(
                res2.db, res2.mask, res2.stats, is_copol=False
            )
        else:
            input_u8_band2 = res2.scaled_u8
        (_c2, _r2, final_u8_band2, _f16b, _sx2, _sy2, _pl2, _pt2) = resize_image_data_with_meta(
            input_u8_band2, None, cols, rows, target_size, BitDepth.U8, pad,
        )
        del res2, input_u8_band2

        rgb = create_synthetic_rgb_by_mode_and_strategy(
            syn_mode, strategy, final_u8_band1, final_u8_band2
        )
        write_rgb_jpeg(output, final_cols, final_rows, np.asarray(rgb))

        if metadata is not None:
            gt_override, proj_override = _rescale_geotransform(
                metadata, cols, rows, final_cols, final_rows, pad_left, pad_top,
                scale_x, scale_y,
            )
            if gt_override is not None:
                write_world_file(output, gt_override)
            if proj_override is not None:
                write_prj_file(output, proj_override)
            create_jpeg_metadata_sidecar_with_overrides_and_extras(
                output, metadata, operation_label, gt_override, proj_override,
                [("synthetic_rgb_mode", syn_mode.display)],
            )
        logger.info("Synthetic RGB JPEG saved with metadata sidecar")
