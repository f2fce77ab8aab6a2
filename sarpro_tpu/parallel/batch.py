"""Pipelined batch driver: host SAFE reads overlap device compute.

The reference's batch mode is a serial for-loop (src/cli/runner.rs:294-340,
src/api/mod.rs:484-533) and its README advises running multiple processes to
scale (README.md:65). Here a small thread pool prefetches upcoming products
(XML parse + TIFF strip reads + host→device transfer enqueue) while the
device crunches the current scene — the async-loader analogue of SURVEY.md
§2.5. Per-scene error tolerance matches the reference: unsupported products
are skipped, failures counted, processing continues.
"""
from __future__ import annotations

import concurrent.futures
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from ..errors import SarproError
from ..params import ProcessingParams

logger = logging.getLogger("sarpro")


class _SceneLoad:
    def __init__(self, path: Path, reader=None, error: Optional[Exception] = None,
                 skipped: bool = False):
        self.path = path
        self.reader = reader
        self.error = error
        self.skipped = skipped


def _load_scene(path: Path, params: ProcessingParams,
                shard_devices: int = 0, direct_io: bool = True) -> _SceneLoad:
    from ..api import _pol_to_reader_hint, _resolve_target_args, scene_skip_reason
    from ..io import raster as raster_mod
    from ..io.safe import DEFER_DEVICE_PUT, SafeReader

    # loader threads do host-only work (SAFE parse, strip reads, native box
    # reduce); device transfers happen on the consumer thread at dispatch —
    # concurrent device_puts from loaders head-of-line-block the consumer's
    # fetches on serial transports
    DEFER_DEVICE_PUT.set(True)
    # batch scans touch each scene once: O_DIRECT chunked DMA keeps the
    # loader off the vCPU (~9% vs ~94% for the buffered fault path measured
    # on this host) and out of the page cache, so the read genuinely
    # overlaps the consumer's compute
    raster_mod.DIRECT_IO.set(bool(direct_io))
    if shard_devices:
        # warps execute inside the reader open (the one loader stage that
        # legitimately dispatches device work); request the row-sharded
        # sampling pass like the single-scene fast path does
        from ..io import warp as warp_mod

        warp_mod.SHARD_DEVICES.set(shard_devices)
    try:
        try:
            reason = scene_skip_reason(path, params)
        except Exception:
            reason = "unreadable product metadata"
        if reason is not None:
            logger.warning("Skipping %s: %s", path, reason)
            return _SceneLoad(path, skipped=True)
        target_arg, resample = _resolve_target_args(params)
        reader = SafeReader.open_with_warnings_with_options(
            path, _pol_to_reader_hint(params.polarization), target_arg,
            resample, params.size,
        )
        if reader is None:
            return _SceneLoad(path, skipped=True)
        return _SceneLoad(path, reader=reader)
    except SarproError as e:
        return _SceneLoad(path, error=e)
    except Exception as e:  # noqa: BLE001 — batch isolation boundary
        return _SceneLoad(path, error=e)


def process_directory_pipelined(
    input_dir,
    output_dir,
    params: ProcessingParams,
    continue_on_error: bool = True,
    prefetch: int = 2,
    resume: bool = False,
    fast: bool = False,
    device_batch: int = 4,
    progress=None,
    shard_devices: int = 0,
    direct_io: bool = True,
):
    """Batch all SAFE subdirectories with `prefetch` scenes loading ahead.

    With `fast=True` the scenes run through the fused single-program
    pipeline AND the encode+file-write stage runs on a dedicated writer
    thread: the device starts scene N+1 while scene N's JPEG/TIFF encodes,
    so steady-state throughput approaches 1/max(stage) instead of
    1/sum(stages) (the reference's loop is strictly serial,
    src/cli/runner.rs:294-340).

    `device_batch > 1` additionally stacks same-shape multiband-JPEG scenes
    into ONE vmapped device program (fast_path.save_multiband_batch_fast):
    one transfer + dispatch + fetch per bucket amortizes per-scene
    dispatch overhead and raises device utilization. Buckets key on the
    exact post-read (rows, cols); staged scenes are capped at
    max(8, 2*device_batch) — mixed-shape directories evict the oldest
    partial bucket per-scene, so memory stays bounded and the device is
    never starved until end-of-input. Partial buckets at end-of-input run
    per-scene (avoids compiling an extra batch size). Note: the vmapped
    bucket program and the per-scene program are compiled separately, so
    XLA may fuse and round them differently — both satisfy the fast-mode
    contract (≤1 quantization bin vs exact mode), but a scene's bytes may
    differ by ±1 u8 step depending on whether it filled a bucket.

    `direct_io` (default on) routes the loaders' contiguous-raster average
    reads through O_DIRECT chunked DMA (io/raster.py): a batch scan touches
    each scene once, so the page cache gains nothing, and the buffered
    fault path burns a core copying pages that the DMA path doesn't.

    Returns a BatchReport (same counters as the reference's batch loops).
    """
    from ..api import BatchReport, iterate_safe_products
    from ..core.save import (
        save_processed_image,
        save_processed_multiband_image_sequential,
    )
    from ..types import OutputFormat, Polarization, ProcessingOperation

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    report = BatchReport()
    paths = list(iterate_safe_products(input_dir))
    total_scenes = len(paths)
    current_scene = [None]

    def tick(current=None):
        """`progress(done, total, current_name)` — live batch progress for
        the GUI; exceptions in the observer must not affect the batch."""
        if current is not None:
            current_scene[0] = current
        if progress is not None:
            try:
                progress(report.processed + report.skipped + report.errors,
                         total_scenes, current_scene[0])
            except Exception:  # noqa: BLE001
                pass

    if resume:
        ext = params.format.extension
        kept = []
        for p in paths:
            if (output_dir / f"{p.name}.{ext}").exists():
                logger.info("Resume: output exists, skipping %s", p)
                report.skipped += 1
                tick()
            else:
                kept.append(p)
        paths = kept
    if not paths:
        return report

    if shard_devices:
        # intra-scene row sharding implies the fast path; it uses the whole
        # mesh per scene, so the device-batch bucketing (which spreads
        # scenes across devices) is disabled in favor of it
        fast = True
        if device_batch > 1:
            logger.info("shard-devices set: device-batch bucketing disabled "
                        "(each scene already spans the mesh)")
            device_batch = 1
    bit_depth = params.bit_depth.to_bit_depth()
    pol = params.polarization

    def run_scene(load: _SceneLoad, write_pool=None):
        """Device compute (+fetch) for one scene; returns the deferred
        write Future in fast mode (None = written inline)."""
        from ..api import _band_pair, _op_band, _single_band

        reader = load.reader
        ext = params.format.extension
        out = output_dir / f"{load.path.name}.{ext}"
        if fast:
            from ..core import fast_path

            if pol.kind in ("vv", "vh", "hh", "hv"):
                return fast_path.save_single_band_fast(
                    _single_band(reader, pol), out, params.format, bit_depth,
                    params.size, reader.metadata, params.pad, params.autoscale,
                    ProcessingOperation.SINGLE_BAND,
                    write_pool=write_pool, shard_devices=shard_devices,
                )
            if pol.kind == "multiband":
                b1, b2, is_vvvh = _band_pair(reader, "Multiband")
                # stage band 1 as its own program, like the serial fast
                # path does during the overlapped pair load (api.py
                # band_stage): the consumer dispatches it asynchronously
                # ahead of band 2 + combine, and the batch driver then
                # runs the SAME split programs as the single-scene CLI —
                # identical bytes, shared compile cache (the monolithic
                # two-band program also lowers poorly on the CPU backend)
                staged = None
                if (params.format is OutputFormat.JPEG and not shard_devices
                        and not fast_path._is_big_scene(
                            *np.shape(b1), params.size)):
                    import jax.numpy as jnp

                    from ..core import fused

                    staged = fused.synrgb_band_stage(
                        jnp.asarray(b1), strategy=params.autoscale,
                        copol=True, target_size=params.size,
                        pad=params.pad)
                return fast_path.save_multiband_fast(
                    b1, b2, out, params.format, bit_depth, params.size,
                    reader.metadata, params.pad, params.autoscale,
                    ProcessingOperation.MULTIBAND_VV_VH if is_vvvh
                    else ProcessingOperation.MULTIBAND_HH_HV,
                    params.synrgb_mode, write_pool=write_pool,
                    shard_devices=shard_devices, staged_b1=staged,
                )
            return fast_path.save_single_band_fast(
                _op_band(reader, pol.op), out, params.format, bit_depth,
                params.size, reader.metadata, params.pad, params.autoscale,
                ProcessingOperation.PolarOp(pol.op),
                write_pool=write_pool, shard_devices=shard_devices,
            )
        if pol.kind in ("vv", "vh", "hh", "hv"):
            save_processed_image(
                _single_band(reader, pol), out, params.format, bit_depth,
                params.size, reader.metadata, params.pad, params.autoscale,
                ProcessingOperation.SINGLE_BAND,
            )
        elif pol.kind == "multiband":
            b1, b2, is_vvvh = _band_pair(reader, "Multiband")
            save_processed_multiband_image_sequential(
                b1, b2, out, params.format, bit_depth, params.size,
                reader.metadata, params.pad, params.autoscale,
                ProcessingOperation.MULTIBAND_VV_VH if is_vvvh
                else ProcessingOperation.MULTIBAND_HH_HV,
                params.synrgb_mode,
            )
        else:
            save_processed_image(
                _op_band(reader, pol.op), out, params.format, bit_depth,
                params.size, reader.metadata, params.pad, params.autoscale,
                ProcessingOperation.PolarOp(pol.op),
            )
        return None

    # device-batch buckets: same-shape multiband-JPEG scenes stacked into
    # one vmapped dispatch; key = (shape, is_vvvh)
    bucketing = (fast and device_batch > 1
                 and pol.kind == "multiband"
                 and params.format is OutputFormat.JPEG
                 and params.size is not None)
    buckets: dict = {}

    # write_futs: deferred encode+write stages (fast mode), resolved as they
    # finish so counters stay accurate; depth-capped so host arrays from at
    # most 2 scenes wait for the writer thread
    write_futs: list[tuple[Path, concurrent.futures.Future]] = []

    def drain_writes(block: bool = False):
        while write_futs:
            path, wfut = write_futs[0]
            if not block and not wfut.done():
                return
            write_futs.pop(0)
            try:
                wfut.result()
                report.processed += 1
                logger.info("Processed: %s", path)
            except Exception as e:  # noqa: BLE001 — batch isolation boundary
                logger.warning("Error writing %s: %s", path, e)
                report.errors += 1
                if not continue_on_error:
                    raise
            finally:
                tick()

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=max(prefetch, 1)) as pool, \
         concurrent.futures.ThreadPoolExecutor(max_workers=1) as writer_pool:
        pending: list[concurrent.futures.Future] = []
        it = iter(paths)

        def refill():
            while len(pending) < max(prefetch, 1) + 1:
                try:
                    p = next(it)
                except StopIteration:
                    return
                pending.append(pool.submit(_load_scene, p, params,
                                           shard_devices, direct_io))

        def record_write(path, wfut):
            if wfut is None:
                report.processed += 1
                logger.info("Processed: %s", path)
                tick()
            else:
                write_futs.append((path, wfut))
                drain_writes()
                if len(write_futs) > 2:
                    _, first = write_futs[0]
                    first.exception()  # wait without raising here
                    drain_writes()

        def flush_bucket(key, per_scene: bool):
            from ..core import fast_path

            items = buckets.pop(key, [])
            if not items:
                return
            is_vvvh = key[1]
            op = (ProcessingOperation.MULTIBAND_VV_VH if is_vvvh
                  else ProcessingOperation.MULTIBAND_HH_HV)
            if not per_scene and len(items) > 1:
                try:
                    futs = fast_path.save_multiband_batch_fast(
                        [(b1, b2, out, meta) for (_, b1, b2, out, meta)
                         in items],
                        params.size, params.pad, params.autoscale, op,
                        params.synrgb_mode, write_pool=writer_pool,
                    )
                except Exception as e:  # noqa: BLE001 — isolation boundary
                    # every scene of the bucket failed with the dispatch
                    logger.warning("Error processing a bucket of %d scenes "
                                   "(%s): %s", len(items),
                                   ", ".join(str(it[0]) for it in items), e)
                    report.errors += len(items)
                    tick()
                    if not continue_on_error:
                        raise
                    return
                # outside the try: a write-failure abort raised by
                # record_write/drain_writes must propagate as itself
                for (path, *_), wfut in zip(items, futs):
                    record_write(path, wfut)
                return
            for path, b1, b2, out, meta in items:
                try:
                    wfut = fast_path.save_multiband_fast(
                        b1, b2, out, params.format, bit_depth, params.size,
                        meta, params.pad, params.autoscale, op,
                        params.synrgb_mode, write_pool=writer_pool,
                    )
                    record_write(path, wfut)
                except Exception as e:  # noqa: BLE001 — isolation boundary
                    logger.warning("Error processing %s: %s", path, e)
                    report.errors += 1
                    tick()
                    if not continue_on_error:
                        raise

        refill()
        while pending:
            fut = pending.pop(0)
            try:
                load = fut.result()
            except Exception as e:  # noqa: BLE001 — loader thread crashed
                logger.warning("Scene loader failed: %s", e)
                report.errors += 1
                tick()
                refill()
                if not continue_on_error:
                    raise
                continue
            refill()
            if load.skipped:
                logger.warning("Skipping unsupported product: %s", load.path)
                report.skipped += 1
                tick()
                continue
            if load.error is not None:
                logger.warning("Error loading %s: %s", load.path, load.error)
                report.errors += 1
                tick()
                if not continue_on_error:
                    raise load.error
                continue
            if bucketing:
                from ..api import _band_pair

                tick(load.path.name)
                try:
                    b1, b2, is_vvvh = _band_pair(load.reader, "Multiband")
                    ext = params.format.extension
                    out = output_dir / f"{load.path.name}.{ext}"
                    key = (tuple(np.asarray(b1).shape), is_vvvh)
                    buckets.setdefault(key, []).append(
                        (load.path, b1, b2, out,
                         load.reader.metadata.copy()))
                except Exception as e:  # noqa: BLE001 — isolation boundary
                    logger.warning("Error staging %s: %s", load.path, e)
                    report.errors += 1
                    tick()
                    if not continue_on_error:
                        raise
                    continue
                if len(buckets[key]) >= device_batch:
                    flush_bucket(key, per_scene=False)
                else:
                    # heterogeneous shapes never fill their buckets (exact
                    # (rows, cols) keys): bound the staged scenes so a
                    # mixed-shape directory neither accumulates every
                    # scene's bands in memory nor starves the device until
                    # end-of-input — evict the oldest partial bucket
                    # per-scene once over the cap
                    cap = max(8, 2 * device_batch)
                    while sum(len(v) for v in buckets.values()) > cap:
                        victim = next((k for k in buckets if k != key), key)
                        flush_bucket(victim, per_scene=True)
                continue
            tick(load.path.name)
            try:
                wfut = run_scene(load, write_pool=writer_pool if fast else None)
            except Exception as e:  # noqa: BLE001 — batch isolation boundary
                logger.warning("Error processing %s: %s", load.path, e)
                report.errors += 1
                tick()
                if not continue_on_error:
                    raise
                continue
            record_write(load.path, wfut)
        # end of input: partial buckets run per-scene (no extra batch-size
        # compiles for a one-off tail)
        for key in list(buckets):
            flush_bucket(key, per_scene=True)
        drain_writes(block=True)
    return report
