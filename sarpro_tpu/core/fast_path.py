"""Fast-mode file processing: the fused single-program pipeline behind the
file API.

Exact mode (core/save.py) reproduces the reference bit-for-bit but pays one
device dispatch per stage; fast mode runs the whole compute chain as ONE XLA
program (core/fused.py) — the benchmark path — and reuses the writers and
geotransform bookkeeping. Differences vs exact mode are bounded by f32
percentile inversion (≤1 histogram bin of window placement).

Scope: the reader's downsample-on-read is folded into the program (DN
resampling happens in-graph), so when a target CRS warp is requested the
warped raster enters the program with resampling already applied — same
result as the reference's single-pass `-ts` warp.
"""
from __future__ import annotations

import functools
import logging
from pathlib import Path

import numpy as np

from ..io.writers.jpeg import (
    preferred_gray_layout,
    preferred_synrgb_layout,
    write_gray_jpeg,
    write_gray_jpeg_dct,
    write_rgb_jpeg,
    write_synrgb_jpeg,
)
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
from ..types import BitDepth, OutputFormat, ProcessingOperation, SyntheticRgbMode
from . import fused
from .save import _rescale_geotransform

logger = logging.getLogger("sarpro")


def _final_dims(in_rows: int, in_cols: int, target_size, pad: bool,
                resample_alg=None):
    rows, cols, _f = fused._plan_read_dims(in_rows, in_cols, target_size,
                                           resample_alg)
    if pad:
        m = max(rows, cols)
        pad_left = (m - cols) // 2
        pad_top = (m - rows) // 2
        return rows, cols, m, m, pad_left, pad_top
    return rows, cols, cols, rows, 0, 0


def _is_big_scene(in_rows: int, in_cols: int, target_size) -> bool:
    """Full-resolution outputs past the single-program HBM budget go through
    the streamed multi-pass path (core/streamed.py)."""
    from .streamed import BIG_SCENE_PIXELS

    return target_size is None and in_rows * in_cols > BIG_SCENE_PIXELS


def _build_shard_mesh(shard_devices: int, rows: int, full_res: bool):
    """Mesh for single-scene row sharding (the TP/SP analogue, SURVEY §2.5),
    or None with the reason logged.

    Full-res configs run the shard_map path whose row splits must divide
    the scene height evenly — pick the largest power-of-two divisor that
    fits the device count. Resample/pad configs take the GSPMD fallback,
    which partitions uneven rows itself."""
    import jax

    from ..parallel.mesh import make_mesh

    avail = len(jax.devices())
    n = avail if shard_devices < 0 else min(shard_devices, avail)
    if n < 2:
        if shard_devices >= 2 or shard_devices < 0:
            logger.warning(
                "shard: %s device(s) requested but only %d available; "
                "running unsharded",
                "all" if shard_devices < 0 else shard_devices, avail)
        return None
    if full_res:
        r = 1
        while r * 2 <= n and rows % (r * 2) == 0:
            r *= 2
        if r < 2:
            logger.warning("shard: %d rows have no even power-of-two split "
                           "across %d devices; running unsharded", rows, n)
            return None
        if r < n:
            logger.info("shard: using %d of %d devices (largest even row "
                        "split of %d rows)", r, n, rows)
        return make_mesh(r, shape=(1, r))
    return make_mesh(n, shape=(1, n))


def save_single_band_fast(
    dn, output, format: OutputFormat, bit_depth: BitDepth, target_size,
    metadata=None, pad: bool = False, strategy=None,
    operation: ProcessingOperation = ProcessingOperation.SINGLE_BAND,
    resample_alg=None, write_pool=None, shard_devices: int = 0,
):
    """Single-band DN → file through the fused program.

    With `write_pool` (an Executor), the encode+file-write stage is
    submitted to it and the Future returned — the batch driver's writer
    thread runs it while the device starts the next scene (the metadata
    snapshot is taken before returning, so the caller may mutate/reuse the
    reader). Without it, writes happen inline and None is returned."""
    output = Path(output)
    in_rows, in_cols = dn.shape
    depth = bit_depth if format is OutputFormat.TIFF else BitDepth.U8
    gray_layout = "u8"
    mesh = (_build_shard_mesh(shard_devices, in_rows,
                              target_size is None and not pad)
            if shard_devices else None)
    if mesh is not None and _is_big_scene(in_rows, in_cols, target_size):
        # big scene + mesh: the whole-block shard_map would materialize
        # full LOCAL f32 intermediates (OOM past the fused budget per
        # shard) — the row-sharded STREAMED programs keep per-shard HBM
        # bounded at any shard count (core/streamed.py)
        from .streamed import grayscale_streamed

        if format is OutputFormat.JPEG:
            gray_layout = preferred_gray_layout()
        out = grayscale_streamed(dn, strategy=strategy, bit_depth=depth,
                                 pad=pad, jpeg_dct=gray_layout == "dct",
                                 mesh=mesh)
    elif mesh is not None:
        import jax.numpy as jnp

        from ..parallel import sharded

        # keep device-resident readers' arrays on device — shard_scene_batch
        # reshards in place; np.asarray here would round-trip the raster
        # through the host. JPEG stays on the u8 host-encode layout: the
        # sharded gray program has no in-graph DCT tail.
        out = sharded.grayscale_batch(
            jnp.asarray(dn)[None], mesh, strategy=strategy, bit_depth=depth,
            target_size=target_size, pad=pad)[0]
    elif _is_big_scene(in_rows, in_cols, target_size):
        from .streamed import grayscale_streamed

        if format is OutputFormat.JPEG:
            gray_layout = preferred_gray_layout()
        out = grayscale_streamed(dn, strategy=strategy, bit_depth=depth,
                                 pad=pad, jpeg_dct=gray_layout == "dct")
    else:
        if format is OutputFormat.JPEG:
            # device JPEG front-end on co-located hosts (see
            # preferred_gray_layout): program ends in quantized DCT blocks
            gray_layout = preferred_gray_layout()
        out = fused.grayscale_pipeline(
            dn, strategy=strategy, bit_depth=depth,
            target_size=target_size, pad=pad, resample_alg=resample_alg,
            jpeg_dct=gray_layout == "dct",
        )
    arr = np.asarray(out)
    rows, cols, final_cols, final_rows, pad_left, pad_top = _final_dims(
        in_rows, in_cols, target_size, pad, resample_alg
    )
    gt_override, proj_override = _rescale_geotransform(
        metadata, cols, rows, final_cols, final_rows, pad_left, pad_top, 1.0, 1.0
    )
    label = operation.metadata_label
    meta_snapshot = metadata.copy() if (metadata is not None
                                        and write_pool is not None) else metadata

    def _write():
        if format is OutputFormat.TIFF:
            writer = write_tiff_u8 if depth is BitDepth.U8 else write_tiff_u16
            ds = writer(output, final_cols, final_rows, arr)
            if meta_snapshot is not None:
                embed_tiff_metadata(ds, meta_snapshot, label, gt_override,
                                    proj_override)
            ds.flush()
        else:
            if gray_layout == "dct":
                write_gray_jpeg_dct(output, final_cols, final_rows, arr)
            else:
                write_gray_jpeg(output, final_cols, final_rows, arr)
            if meta_snapshot is not None:
                if gt_override is not None:
                    write_world_file(output, gt_override)
                if proj_override is not None:
                    write_prj_file(output, proj_override)
                create_jpeg_metadata_sidecar_with_overrides(
                    output, meta_snapshot, label, gt_override, proj_override
                )
        logger.info("fast: saved %s", output)

    if write_pool is not None:
        return write_pool.submit(_write)
    _write()
    return None


def save_multiband_fast(
    dn1, dn2, output, format: OutputFormat, bit_depth: BitDepth, target_size,
    metadata=None, pad: bool = False, strategy=None,
    operation: ProcessingOperation = ProcessingOperation.MULTIBAND_VV_VH,
    syn_mode: SyntheticRgbMode = SyntheticRgbMode.DEFAULT,
    resample_alg=None, write_pool=None, staged_b1=None,
    shard_devices: int = 0,
):
    """Dual-band DN → multiband TIFF or synRGB JPEG through fused programs.

    `write_pool` defers the encode+write stage to the given Executor and
    returns its Future (see save_single_band_fast). `staged_b1` is band 1's
    already-dispatched device program output (the reader's overlapped pair
    load, api.py fast mode) — when present the synRGB path runs only band
    2's program plus the combine, identical math cut at the u8 boundary."""
    output = Path(output)
    in_rows, in_cols = dn1.shape
    rows, cols, final_cols, final_rows, pad_left, pad_top = _final_dims(
        in_rows, in_cols, target_size, pad, resample_alg
    )
    gt_override, proj_override = _rescale_geotransform(
        metadata, cols, rows, final_cols, final_rows, pad_left, pad_top, 1.0, 1.0
    )
    label = operation.metadata_label
    big = _is_big_scene(in_rows, in_cols, target_size)
    mesh = (_build_shard_mesh(shard_devices, in_rows,
                              target_size is None and not pad)
            if shard_devices else None)
    meta_snapshot = metadata.copy() if (metadata is not None
                                        and write_pool is not None) else metadata
    if format is OutputFormat.TIFF:
        if mesh is not None and big:
            # big scene + mesh: row-sharded streamed programs (bounded
            # per-shard HBM at any shard count — see save_single_band_fast)
            from .streamed import grayscale_streamed

            gray = functools.partial(grayscale_streamed, strategy=strategy,
                                     bit_depth=bit_depth, pad=pad, mesh=mesh)
            b1 = np.asarray(gray(dn1))
            b2 = np.asarray(gray(dn2))
        elif mesh is not None:
            import jax.numpy as jnp

            from ..parallel import sharded

            # both bands ride the batch ('scene') axis of the same program;
            # jnp.stack keeps device-resident bands on device
            both = sharded.grayscale_batch(
                jnp.stack([jnp.asarray(dn1), jnp.asarray(dn2)]), mesh,
                strategy=strategy, bit_depth=bit_depth,
                target_size=target_size, pad=pad)
            b1, b2 = np.asarray(both[0]), np.asarray(both[1])
        else:
            if big:
                from .streamed import grayscale_streamed

                gray = functools.partial(grayscale_streamed,
                                         strategy=strategy,
                                         bit_depth=bit_depth, pad=pad)
            else:
                gray = functools.partial(
                    fused.grayscale_pipeline, strategy=strategy,
                    bit_depth=bit_depth, target_size=target_size, pad=pad,
                    resample_alg=resample_alg)
            b1 = np.asarray(gray(dn1))
            b2 = np.asarray(gray(dn2))

        def _write():
            writer = (write_tiff_multiband_u8 if bit_depth is BitDepth.U8
                      else write_tiff_multiband_u16)
            ds = writer(output, final_cols, final_rows, b1, b2)
            if meta_snapshot is not None:
                embed_tiff_metadata(ds, meta_snapshot, label, gt_override,
                                    proj_override)
            ds.flush()
            logger.info("fast: saved %s", output)
    else:
        if mesh is not None and big:
            from .streamed import synrgb_streamed

            order = ("dct" if preferred_synrgb_layout() == "dct"
                     else "rgb")
            rgb = np.asarray(synrgb_streamed(
                dn1, dn2, strategy=strategy, pad=pad, layout=order,
                mesh=mesh))
        elif mesh is not None:
            import jax.numpy as jnp

            from ..parallel import sharded

            # the full-res shard_map branch supports interleaved RGB only;
            # resample/pad configs (GSPMD) keep the writer's preferred
            # layout incl. the device JPEG front-end
            full = target_size is None and not pad
            order = "rgb" if full else preferred_synrgb_layout()
            rgb = np.asarray(sharded.synrgb_batch(
                jnp.asarray(dn1)[None], jnp.asarray(dn2)[None], mesh,
                strategy=strategy, target_size=target_size, pad=pad,
                channel_order=order)[0])
        elif big:
            from .streamed import synrgb_streamed

            order = ("dct" if preferred_synrgb_layout() == "dct"
                     else "rgb")
            rgb = np.asarray(synrgb_streamed(
                dn1, dn2, strategy=strategy, pad=pad, layout=order))
        else:
            # device emits the writer's preferred layout: planar YCbCr for
            # the native encoder (color conversion fused in-graph), else
            # BGR for cv2 — no host-side channel work either way
            order = preferred_synrgb_layout()
            if staged_b1 is not None:
                b2_dev = fused.synrgb_band_stage(
                    dn2, strategy=strategy, copol=False,
                    target_size=target_size, pad=pad,
                    resample_alg=resample_alg)
                rgb = np.asarray(fused.synrgb_combine_stage(
                    staged_b1, b2_dev, strategy=strategy, suppressed=None,
                    channel_order=order))
            else:
                rgb = np.asarray(fused.synrgb_pipeline(
                    dn1, dn2, strategy=strategy, target_size=target_size,
                    pad=pad, resample_alg=resample_alg, channel_order=order))

        def _write():
            write_synrgb_jpeg(output, final_cols, final_rows, rgb,
                              layout=order)
            if meta_snapshot is not None:
                if gt_override is not None:
                    write_world_file(output, gt_override)
                if proj_override is not None:
                    write_prj_file(output, proj_override)
                create_jpeg_metadata_sidecar_with_overrides_and_extras(
                    output, meta_snapshot, label, gt_override, proj_override,
                    [("synthetic_rgb_mode", syn_mode.display)],
                )
            logger.info("fast: saved %s", output)

    if write_pool is not None:
        return write_pool.submit(_write)
    _write()
    return None


def save_multiband_batch_fast(
    items, target_size, pad: bool = False, strategy=None,
    operation: ProcessingOperation = ProcessingOperation.MULTIBAND_VV_VH,
    syn_mode: SyntheticRgbMode = SyntheticRgbMode.DEFAULT,
    resample_alg=None, write_pool=None,
):
    """Device-batched synRGB JPEG for same-shape scenes: `items` is a list
    of (dn1, dn2, output_path, metadata). All scenes run as ONE vmapped
    device program (parallel/sharded.synrgb_batch on the local mesh) —
    one transfer + one dispatch + one fetch for the whole bucket, which
    amortizes per-scene dispatch cost in the batch driver. Returns the
    list of deferred write Futures (or None entries if written inline).

    Caller guarantees: JPEG output, equal dn shapes, non-big scenes.
    """
    import jax

    from ..parallel import sharded
    from ..parallel.mesh import make_mesh

    layout = preferred_synrgb_layout()
    vv = np.stack([np.asarray(it[0]) for it in items])
    vh = np.stack([np.asarray(it[1]) for it in items])
    # pure scene-parallel mesh: the scene axis must DIVIDE the bucket, and
    # row=1 sidesteps row/channel divisibility — bucketed scenes are
    # already downsampled, so intra-scene sharding has nothing to win
    # here. Pick the LARGEST divisor of the bucket that fits the device
    # count (gcd would collapse coprime configs, e.g. 3 scenes on 4
    # devices, to one device).
    n_dev = len(jax.devices())
    n = max(d for d in range(1, min(n_dev, len(items)) + 1)
            if len(items) % d == 0)
    mesh = make_mesh(n, shape=(n, 1))
    out = np.asarray(sharded.synrgb_batch(
        vv, vh, mesh, strategy=strategy, target_size=target_size, pad=pad,
        channel_order=layout,
    ))
    in_rows, in_cols = items[0][0].shape
    rows, cols, final_cols, final_rows, pad_left, pad_top = _final_dims(
        in_rows, in_cols, target_size, pad, resample_alg
    )
    label = operation.metadata_label
    futs = []
    for arr, (_, _, output, metadata) in zip(out, items):
        output = Path(output)
        gt_override, proj_override = _rescale_geotransform(
            metadata, cols, rows, final_cols, final_rows, pad_left, pad_top,
            1.0, 1.0
        )
        meta_snapshot = metadata.copy() if (metadata is not None
                                            and write_pool is not None) else metadata

        def _write(arr=arr, output=output, meta_snapshot=meta_snapshot,
                   gt_override=gt_override, proj_override=proj_override):
            write_synrgb_jpeg(output, final_cols, final_rows, arr,
                              layout=layout)
            if meta_snapshot is not None:
                if gt_override is not None:
                    write_world_file(output, gt_override)
                if proj_override is not None:
                    write_prj_file(output, proj_override)
                create_jpeg_metadata_sidecar_with_overrides_and_extras(
                    output, meta_snapshot, label, gt_override, proj_override,
                    [("synthetic_rgb_mode", syn_mode.display)],
                )
            logger.info("fast: saved %s", output)

        if write_pool is not None:
            futs.append(write_pool.submit(_write))
        else:
            _write()
            futs.append(None)
    return futs
