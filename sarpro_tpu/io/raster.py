"""Generic raster reader — parity with the reference's GdalSarReader
(src/io/gdal.rs:37-187), built on the self-contained TIFF codec.

Provides: dataset metadata (size/bands/geotransform with identity fallback/
projection with GCP fallback/EPSG extraction/flat metadata map), full-window
f32 band reads, and resampled (decimated) reads for downsample-on-read.
"""
from __future__ import annotations

import contextvars
import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np

import logging

from .. import _native
from ..errors import RasterError
from . import geodesy
from .tiffio import GeoInfo, TiffReader

logger = logging.getLogger("sarpro")

# Route contiguous-raster average reads through O_DIRECT chunked DMA instead
# of the page cache. Set by batch loader threads (parallel/batch.py): a
# directory scan touches each scene once, so caching it evicts useful pages,
# and the buffered fault path spends ~94% of a vCPU copying while O_DIRECT
# measures ~9% — the loader genuinely overlaps the consumer's compute.
DIRECT_IO: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "DIRECT_IO", default=False)


def _average_windows(in_size: int, out_size: int):
    """Contiguous uniform-weight source windows of the 'average' filter,
    derived from the SAME coefficient builder the device resampler uses
    (core/resize._build_coeffs) so host and device boxes match exactly.
    Returns (starts, counts) int32 arrays, or None if the windows are not
    plain boxes (never happens for the box kernel; guards the fast path)."""
    from ..core.resize import _build_coeffs

    starts, weights = _build_coeffs(in_size, out_size, "average")
    nz = weights > 0
    first = nz.argmax(axis=1).astype(np.int64)
    count = nz.sum(axis=1).astype(np.int64)
    if np.any(count <= 0):
        return None
    idx = np.arange(weights.shape[1])
    contiguous = (idx >= first[:, None]) & (idx < (first + count)[:, None])
    if not np.array_equal(contiguous, nz):
        return None
    ys = (starts.astype(np.int64) + first).astype(np.int32)
    return ys, count.astype(np.int32)


@dataclasses.dataclass
class RasterMetadata:
    """Mirror of the reference's GdalMetadata (gdal.rs:16-35)."""

    size_x: int
    size_y: int
    bands: int
    geotransform: list[float]
    projection: str
    epsg: Optional[int]
    metadata: dict[str, str]


def parse_epsg(wkt: str) -> Optional[int]:
    """EPSG code from a WKT AUTHORITY tag (reference: gdal.rs:43-53)."""
    key = 'AUTHORITY["EPSG","'
    idx = wkt.rfind(key)
    if idx < 0:
        return None
    start = idx + len(key)
    end = wkt.find('"', start)
    if end <= start:
        return None
    try:
        return int(wkt[start:end])
    except ValueError:
        return None


class RasterReader:
    """Opens any (Geo)TIFF raster via the self-contained codec, common
    non-TIFF formats (PNG/JPEG/JPEG2000/BMP/GIF/PPM/WebP, world-file
    georeferencing) via the PIL backend, and CF-convention netCDF classic
    grids via the scipy backend — the format breadth of the reference's
    GdalSarReader::open (gdal.rs:57-104)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        # content-probe first, like GDAL: a TIFF named scene.img must still
        # open through the native codec regardless of extension
        try:
            with open(self.path, "rb") as fh:
                magic = fh.read(4)
        except OSError as e:
            raise RasterError(f"failed to open raster {self.path}: {e}") from e
        if magic[:2] in (b"II", b"MM"):
            try:
                self._tiff = TiffReader(self.path)
            except RasterError:
                raise
            except Exception as e:  # pragma: no cover
                raise RasterError(f"failed to open raster {self.path}: {e}") from e
        elif magic[:3] == b"CDF" or magic.startswith(b"\x89HDF"):
            from .ncraster import NetcdfRaster

            self._tiff = NetcdfRaster(self.path)
        else:
            from .pilraster import PIL_EXTENSIONS, PilRaster

            try:
                self._tiff = PilRaster(self.path)
            except RasterError as e:
                raise RasterError(
                    f"unsupported raster format: {self.path} is neither a "
                    f"TIFF nor PIL-decodable ({PIL_EXTENSIONS}): {e}"
                ) from e
        gi: GeoInfo = self._tiff.geo_info()
        self.geo = gi
        # identity fallback (reference: gdal.rs:64-67)
        gt = gi.geotransform or [0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
        # projection: dataset CRS, falling back to GCP projection (gdal.rs:68-83).
        # A GCP'd raster (multiple tiepoints) is itself UNprojected — its
        # geokeys describe the GCP SRS, so the dataset EPSG must stay None
        # (otherwise the skip-warp guard would wrongly fire).
        projection = ""
        epsg = gi.epsg
        if gi.gcps is not None:
            epsg = None
            gcp_epsg = gi.gcp_epsg or 4326
            projection = geodesy.epsg_to_wkt(gcp_epsg) or f"EPSG:{gcp_epsg}"
        elif epsg is not None:
            projection = geodesy.epsg_to_wkt(epsg) or f"EPSG:{epsg}"
        self.metadata = RasterMetadata(
            size_x=self._tiff.width,
            size_y=self._tiff.height,
            bands=self._tiff.samples,
            geotransform=gt,
            projection=projection,
            epsg=epsg,
            metadata=self._tiff.gdal_metadata(),
        )

    @property
    def gcps(self) -> Optional[np.ndarray]:
        return self.geo.gcps

    def gcp_projection(self) -> str:
        if self.geo.gcps is None:
            return ""
        code = self.geo.gcp_epsg or 4326
        return geodesy.epsg_to_wkt(code) or f"EPSG:{code}"

    def read_band(self, band: int = 1) -> np.ndarray:
        """Full-window f32 read (reference: gdal.rs:107-141)."""
        return self._tiff.read(band).astype(np.float32)

    def read_band_resampled(
        self, band: int, out_cols: int, out_rows: int, alg: str | None = None
    ) -> np.ndarray:
        """Decimated read to (out_rows, out_cols) — the downsample-on-read
        fast path (reference: gdal.rs:145-177).

        Average-filter reductions stream through the native single-pass box
        reducer (one touch of the source bytes, no full-raster f32
        materialization, no device round-trip); other filters read full and
        resample on device."""
        filt = alg or "average"
        t = self._tiff
        if (isinstance(t, TiffReader)
                and filt in ("average", "box") and t.samples == 1 and band == 1
                and t.dtype == np.dtype(np.uint16)
                and out_rows < t.height and out_cols < t.width
                and _native.available()):
            ywin = _average_windows(t.height, out_rows)
            xwin = _average_windows(t.width, out_cols)
            if ywin is not None and xwin is not None:
                return self._read_average_streamed(out_rows, out_cols,
                                                   ywin, xwin)
        from ..core.resize import resample_plane

        full = t.read(band).astype(np.float32)
        return np.asarray(resample_plane(full, out_rows, out_cols, filt))

    def read_band_resampled_to_device(
        self, band: int, out_cols: int, out_rows: int,
        alg: str | None = None, chunk_out_rows: int = 512,
    ):
        """Decimated read that streams host→device copies per chunk:
        each reduced output chunk is enqueued with
        `jax.device_put` while the next chunk decodes, and the full device
        plane is assembled with one on-device concatenate when the last
        chunk lands. Falls back to `read_band_resampled` + one transfer when
        the native streamed route is unavailable."""
        import jax
        import jax.numpy as jnp

        from .. import _native

        filt = alg or "average"
        t = self._tiff
        native_ok = (
            isinstance(t, TiffReader)
            and filt in ("average", "box") and t.samples == 1 and band == 1
            and t.dtype == np.dtype(np.uint16)
            and out_rows < t.height and out_cols < t.width
            and _native.available()
        )
        ywin = _average_windows(t.height, out_rows) if native_ok else None
        xwin = _average_windows(t.width, out_cols) if native_ok else None
        if ywin is None or xwin is None:
            return jnp.asarray(self.read_band_resampled(band, out_cols,
                                                        out_rows, alg))
        ys, yc = ywin
        xs, xc = xwin
        chunks = []
        for o0 in range(0, out_rows, chunk_out_rows):
            o1 = min(o0 + chunk_out_rows, out_rows)
            r0, r1 = int(ys[o0]), int(ys[o1 - 1] + yc[o1 - 1])
            src = np.ascontiguousarray(
                t.read_strip_range(r0, r1, band), np.uint16)
            part = np.empty((o1 - o0, out_cols), np.float32)
            _native.box_reduce_u16(src, part, o0, o1, ys, yc, xs, xc,
                                   src_row0=r0)
            chunks.append(jax.device_put(part))  # async enqueue
        if len(chunks) == 1:
            return chunks[0]
        return jnp.concatenate(chunks, axis=0)

    def _read_average_streamed(self, out_rows: int, out_cols: int,
                               ywin, xwin) -> np.ndarray:
        """Single-pass host box-average.

        Contiguous uncompressed rasters (the Sentinel-1 GRD layout) reduce
        straight from an mmap — kernel readahead overlaps disk I/O with the
        reduction. Compressed/striped layouts stream strip-range decodes in
        chunks with a one-deep prefetch thread."""
        import concurrent.futures

        from .. import _native

        t = self._tiff
        ys, yc = ywin
        xs, xc = xwin
        out = np.empty((out_rows, out_cols), np.float32)
        if (DIRECT_IO.get() and t._contiguous_uncompressed()
                and t.dtype.itemsize == 2):
            try:
                return self._read_average_direct(out, ywin, xwin)
            except OSError as e:
                logger.info("direct-I/O read unavailable (%s); using the "
                            "buffered mmap path", e)
        if t._contiguous_uncompressed() and t.dtype.itemsize == 2:
            import mmap as _mmap

            with open(self.path, "rb") as fh:
                mm = _mmap.mmap(fh.fileno(), 0, prot=_mmap.PROT_READ)
                try:
                    if hasattr(_mmap, "MADV_SEQUENTIAL"):
                        mm.madvise(_mmap.MADV_SEQUENTIAL)
                    src = np.frombuffer(
                        mm, dtype=t.dtype, count=t.height * t.width,
                        offset=int(t.offsets[0]),
                    ).reshape(t.height, t.width)
                    _native.box_reduce_u16(src, out, 0, out_rows, ys, yc,
                                           xs, xc)
                    del src
                finally:
                    mm.close()
            return out
        # chunked streaming: group output rows into ~4096-source-row chunks
        chunks = []
        oy0 = 0
        while oy0 < out_rows:
            r0 = int(ys[oy0])
            oy1 = oy0 + 1
            while oy1 < out_rows and int(ys[oy1] + yc[oy1]) - r0 <= 4096:
                oy1 += 1
            r1 = int(ys[oy1 - 1] + yc[oy1 - 1])
            chunks.append((oy0, oy1, r0, r1))
            oy0 = oy1
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            nxt = pool.submit(t.read_strip_range, chunks[0][2], chunks[0][3])
            for i, (o0, o1, r0, r1) in enumerate(chunks):
                src = np.ascontiguousarray(nxt.result(), np.uint16)
                if i + 1 < len(chunks):
                    nxt = pool.submit(t.read_strip_range,
                                      chunks[i + 1][2], chunks[i + 1][3])
                _native.box_reduce_u16(src, out[o0:o1], o0, o1, ys, yc,
                                       xs, xc, src_row0=r0)
        return out

    def _read_average_direct(self, out: np.ndarray, ywin, xwin) -> np.ndarray:
        """O_DIRECT chunked pre-reduce for contiguous uncompressed rasters.

        Bypasses the page cache: each ~32 MB source chunk is DMA'd into a
        page-aligned double buffer (one-deep prefetch thread reads chunk
        i+1 while chunk i reduces), so a batch directory scan neither
        evicts the cache nor burns the vCPU copying pages. Output is
        bit-identical to the buffered mmap path — same windows, same
        native reducer. Raises OSError where O_DIRECT is unsupported
        (caller falls back to the mmap path)."""
        import concurrent.futures
        import mmap as _mmap
        import os

        t = self._tiff
        ys, yc = ywin
        xs, xc = xwin
        out_rows = out.shape[0]
        row_bytes = t.width * t.dtype.itemsize
        base = int(t.offsets[0])
        align = 4096
        budget = 32 << 20
        # group output rows into <=~32 MB source-row chunks (window rows of
        # one output row never split across chunks)
        chunks = []
        oy0 = 0
        while oy0 < out_rows:
            r0 = int(ys[oy0])
            oy1 = oy0 + 1
            while (oy1 < out_rows
                   and (int(ys[oy1] + yc[oy1]) - r0) * row_bytes <= budget):
                oy1 += 1
            chunks.append((oy0, oy1, r0, int(ys[oy1 - 1] + yc[oy1 - 1])))
            oy0 = oy1
        # one output row's window may alone exceed the budget (extreme
        # thumbnail reductions) — size the double buffers for the largest
        buf_len = (max(r1 - r0 for _, _, r0, r1 in chunks) * row_bytes
                   + 2 * align)
        fd = os.open(self.path, os.O_RDONLY | os.O_DIRECT)
        bufs: list = [None, None]
        try:
            def fetch(i):
                o0, o1, r0, r1 = chunks[i]
                off0 = base + r0 * row_bytes
                off1 = base + r1 * row_bytes
                a0 = off0 & ~(align - 1)
                need = ((off1 - a0) + align - 1) & ~(align - 1)
                bi = i & 1
                if bufs[bi] is None:
                    bufs[bi] = _mmap.mmap(-1, buf_len)
                mv = memoryview(bufs[bi])[:need]
                got = 0
                while got < need:
                    n = os.preadv(fd, [mv[got:]], a0 + got)
                    if n <= 0:
                        break  # EOF: trailing bytes past off1 are slack
                    got += n
                del mv
                if got < off1 - a0:
                    raise OSError(f"short O_DIRECT read ({got} of "
                                  f"{off1 - a0} bytes)")
                src = np.frombuffer(bufs[bi], dtype=t.dtype,
                                    count=(r1 - r0) * t.width,
                                    offset=off0 - a0).reshape(r1 - r0,
                                                              t.width)
                return src, o0, o1, r0
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                nxt = pool.submit(fetch, 0)
                for i in range(len(chunks)):
                    src, o0, o1, r0 = nxt.result()
                    if i + 1 < len(chunks):
                        nxt = pool.submit(fetch, i + 1)
                    _native.box_reduce_u16(src, out[o0:o1], o0, o1, ys, yc,
                                           xs, xc, src_row0=r0)
                    del src
        finally:
            os.close(fd)
        return out

    def close(self):
        self._tiff.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
