"""On-device reprojection — the accelerator replacement for `gdalwarp`.

The reference shells out to gdalwarp to reproject Sentinel-1 GRD rasters
(src/io/sentinel1.rs:988-1071: `-of VRT -r {near,bilinear,cubic} -tps` with
GCPs when the raster is unprojected). Here the warp is decomposed device-first:

  host (f64, tiny):
    1. build the source→lon/lat mapping (affine+projection, or a thin-plate
       spline fitted on the GCPs — the `-tps` equivalent);
    2. suggest the output grid (bbox of the mapped source border in the
       target CRS, gdalwarp-style suggested resolution, or the reference's
       `-ts` sizing from the source dims);
    3. evaluate the *inverse* mapping (target pixel → source pixel) on a
       coarse control grid — exactly the role of GDAL's approximate
       transformer (default 0.125 px tolerance); we use a dense-enough grid
       that bilinear interpolation of the mapping stays sub-0.1 px;

  device (f32, all per-pixel work):
    4. bilinearly upsample the mapping grid to every output pixel and
       gather-sample the source raster with the chosen kernel
       (near / bilinear / cubic) — one fused XLA program, no host round-trips.

The reference's `-r` mapping quirk is preserved: lanczos (and anything else
unrecognized) falls back to bilinear (sentinel1.rs:937-942).
"""
from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import ProcessingError
from . import geodesy

logger = logging.getLogger("sarpro")

GRID_STEP = 32  # output pixels per mapping-grid cell (≲0.05 px interp error)
MAX_GRID = 257

# --shard-devices plumbing: the warp runs inside the reader open (the
# single-pass `-ts` equivalent), so the fast path requests row sharding
# through a context var rather than threading a parameter through the
# reader surface. 0 = unsharded, -1 = all local devices.
from contextvars import ContextVar

SHARD_DEVICES: ContextVar[int] = ContextVar("warp_shard_devices", default=0)


def _shard_mesh():
    """Mesh for the sharded sampling pass, or None (unsharded)."""
    n_req = SHARD_DEVICES.get()
    if not n_req:
        return None
    import jax

    avail = len(jax.devices())
    n = avail if n_req < 0 else min(n_req, avail)
    if n < 2:
        return None
    from ..parallel.warp import make_row_mesh

    return make_row_mesh(n)


@dataclasses.dataclass
class WarpResult:
    data: jax.Array  # f32 (rows, cols)
    geotransform: list[float]
    projection: str
    epsg: int


def _resample_name(alg: Optional[str]) -> str:
    """gdalwarp -r mapping with the lanczos→bilinear quirk
    (reference: sentinel1.rs:937-942)."""
    if alg in ("nearest", "near"):
        return "near"
    if alg == "cubic":
        return "cubic"
    return "bilinear"


class _SourceMapping:
    """source pixel ↔ lon/lat, from an affine+CRS, GCP TPS, or — when the
    measurement TIFF carries no GCPs — the annotation XML's geolocation grid
    points as TPS control points (the lattice GDAL's `-tps` would otherwise
    read from the raster; reference: sentinel1.rs:1017-1028)."""

    def __init__(self, reader, geolocation_grid: Optional[np.ndarray] = None):
        gt = reader.metadata.geotransform
        self.is_affine = (
            reader.metadata.epsg is not None
            and gt is not None
            and not (gt[0] == 0 and gt[1] == 1 and gt[2] == 0
                     and gt[3] == 0 and gt[4] == 0 and gt[5] == 1)
        )
        if self.is_affine:
            self.src_epsg = reader.metadata.epsg
            self.gt = gt
            det = gt[1] * gt[5] - gt[2] * gt[4]
            if det == 0:
                raise ProcessingError("degenerate source geotransform")
            self.inv = np.array([
                [gt[5] / det, -gt[2] / det],
                [-gt[4] / det, gt[1] / det],
            ])
            return
        gcps = reader.gcps
        if gcps is not None and len(gcps) >= 3:
            # GCP SRS fallback to EPSG:4326 (reference: sentinel1.rs:1020-1025)
            self.src_epsg = reader.geo.gcp_epsg or 4326
            pix = gcps[:, :2]
            lonlat = np.stack(
                geodesy.project_inverse(gcps[:, 2], gcps[:, 3], self.src_epsg), axis=-1
            )
        elif geolocation_grid is not None and len(geolocation_grid) >= 3:
            # annotation geolocationGridPointList: [pixel, line, lon, lat],
            # already geographic
            self.src_epsg = 4326
            pix = np.asarray(geolocation_grid[:, :2], np.float64)
            lonlat = np.asarray(geolocation_grid[:, 2:4], np.float64)
            logger.info("Warp: TPS from %d annotation geolocation grid points",
                        len(pix))
        else:
            raise ProcessingError(
                "source raster has neither a projection, GCPs, nor an "
                "annotation geolocation grid; cannot warp"
            )
        self.fwd_tps = geodesy.ThinPlateSpline2D(pix, lonlat)
        self.inv_tps = geodesy.ThinPlateSpline2D(lonlat, pix)

    def pixels_to_lonlat(self, cols, rows):
        if self.is_affine:
            gt = self.gt
            x = gt[0] + cols * gt[1] + rows * gt[2]
            y = gt[3] + cols * gt[4] + rows * gt[5]
            return geodesy.project_inverse(x, y, self.src_epsg)
        out = self.fwd_tps(np.stack([cols, rows], axis=-1).reshape(-1, 2))
        return out[:, 0].reshape(np.shape(cols)), out[:, 1].reshape(np.shape(rows))

    def lonlat_to_pixels(self, lon, lat):
        if self.is_affine:
            x, y = geodesy.project_forward(lon, lat, self.src_epsg)
            dx = np.asarray(x) - self.gt[0]
            dy = np.asarray(y) - self.gt[3]
            col = self.inv[0, 0] * dx + self.inv[0, 1] * dy
            row = self.inv[1, 0] * dx + self.inv[1, 1] * dy
            return col, row
        pts = np.stack([np.ravel(lon), np.ravel(lat)], axis=-1)
        out = self.inv_tps(pts)
        return out[:, 0].reshape(np.shape(lon)), out[:, 1].reshape(np.shape(lat))


def _suggest_output_grid(mapping: _SourceMapping, src_cols: int, src_rows: int,
                         dst_epsg: int, target_size: Optional[int]):
    """Output bbox + size. Resolution follows gdalwarp's suggested-output
    heuristic (preserve approximate source sampling); `-ts`-style sizing from
    the source dims replicates the reference's single-pass path
    (sentinel1.rs:1005-1015)."""
    # sample the source border + interior on a coarse lattice
    ns = 21
    cs = np.linspace(0, src_cols, ns)
    rs = np.linspace(0, src_rows, ns)
    cc, rr = np.meshgrid(cs, rs)
    lon, lat = mapping.pixels_to_lonlat(cc.ravel(), rr.ravel())
    tx, ty = geodesy.project_forward(lon, lat, dst_epsg)
    tx = np.asarray(tx).reshape(ns, ns)
    ty = np.asarray(ty).reshape(ns, ns)
    # out-of-domain lattice corners come back nan from the proj_pipe
    # backend (gdalwarp likewise drops failed transformer samples)
    if not (np.isfinite(tx).any() and np.isfinite(ty).any()):
        raise ProcessingError(
            "warp: no source sample projects into the target CRS domain")
    xmin, xmax = float(np.nanmin(tx)), float(np.nanmax(tx))
    ymin, ymax = float(np.nanmin(ty)), float(np.nanmax(ty))

    if target_size is not None:
        long_side = max(src_cols, src_rows)
        scale = min(target_size / long_side, 1.0)
        out_cols = max(int(np.floor(src_cols * scale + 0.5)), 1)
        out_rows = max(int(np.floor(src_rows * scale + 0.5)), 1)
    else:
        # mean step length along the lattice ≈ source ground sampling
        dxs = np.hypot(np.diff(tx, axis=1), np.diff(ty, axis=1))
        dys = np.hypot(np.diff(tx, axis=0), np.diff(ty, axis=0))
        px_per_cell_x = src_cols / (ns - 1)
        px_per_cell_y = src_rows / (ns - 1)
        with np.errstate(invalid="ignore"):
            res = float((np.nanmean(dxs) / px_per_cell_x
                         + np.nanmean(dys) / px_per_cell_y) / 2.0)
        if not np.isfinite(res) or res <= 0:
            raise ProcessingError("could not suggest warp output resolution")
        out_cols = max(int(np.ceil((xmax - xmin) / res)), 1)
        out_rows = max(int(np.ceil((ymax - ymin) / res)), 1)

    gt = [xmin, (xmax - xmin) / out_cols, 0.0, ymax, 0.0, -(ymax - ymin) / out_rows]
    return out_cols, out_rows, gt


def _warp_sample_block(src, map_x, map_y, out_rows: int, out_cols: int,
                       method: str, row0, block_rows: int):
    """Device body: upsample the mapping grid to output rows
    [row0, row0+block_rows) and gather-sample the source. `row0` may be a
    traced scalar (the sharded sampler computes it from the mesh axis
    index); with row0=0 and block_rows=out_rows this is the whole-output
    program. Row coordinates are formed as row0 + local iota — integers,
    exact in f32 — so a sharded block is BIT-IDENTICAL to the same rows of
    the unsharded output. Out-of-bounds → 0."""
    h, w = src.shape
    gh, gw = map_x.shape

    r = (jnp.float32(row0)
         + jax.lax.broadcasted_iota(jnp.float32, (block_rows, out_cols), 0))
    c = jax.lax.broadcasted_iota(jnp.float32, (block_rows, out_cols), 1)
    # mapping-grid coordinates of each output pixel (grid spans the output)
    gr = r * ((gh - 1) / max(out_rows - 1, 1))
    gc = c * ((gw - 1) / max(out_cols - 1, 1))
    gr0 = jnp.clip(jnp.floor(gr), 0, gh - 2).astype(jnp.int32)
    gc0 = jnp.clip(jnp.floor(gc), 0, gw - 2).astype(jnp.int32)
    fr = gr - gr0
    fc = gc - gc0

    def interp(grid):
        flat = grid.ravel()
        i00 = jnp.take(flat, gr0 * gw + gc0)
        i01 = jnp.take(flat, gr0 * gw + gc0 + 1)
        i10 = jnp.take(flat, (gr0 + 1) * gw + gc0)
        i11 = jnp.take(flat, (gr0 + 1) * gw + gc0 + 1)
        top = i00 * (1 - fc) + i01 * fc
        bot = i10 * (1 - fc) + i11 * fc
        return top * (1 - fr) + bot * fr

    sx = interp(map_x)  # source col
    sy = interp(map_y)  # source row

    flat_src = src.ravel()

    def fetch(iy, ix):
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        idx = jnp.clip(iy, 0, h - 1) * w + jnp.clip(ix, 0, w - 1)
        return jnp.where(valid, jnp.take(flat_src, idx), 0.0), valid

    if method == "near":
        ix = jnp.floor(sx + 0.5).astype(jnp.int32)
        iy = jnp.floor(sy + 0.5).astype(jnp.int32)
        v, _ = fetch(iy, ix)
        return v

    if method == "bilinear":
        x0 = jnp.floor(sx)
        y0 = jnp.floor(sy)
        fx = sx - x0
        fy = sy - y0
        x0 = x0.astype(jnp.int32)
        y0 = y0.astype(jnp.int32)
        v00, m00 = fetch(y0, x0)
        v01, m01 = fetch(y0, x0 + 1)
        v10, m10 = fetch(y0 + 1, x0)
        v11, m11 = fetch(y0 + 1, x0 + 1)
        w00 = (1 - fx) * (1 - fy)
        w01 = fx * (1 - fy)
        w10 = (1 - fx) * fy
        w11 = fx * fy
        wsum = (w00 * m00 + w01 * m01 + w10 * m10 + w11 * m11)
        val = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11
        return jnp.where(wsum > 0, val / jnp.maximum(wsum, 1e-20), 0.0)

    # cubic (Keys a=-0.5), 4x4 taps
    a = -0.5

    def keys(t):
        at = jnp.abs(t)
        at2 = at * at
        at3 = at2 * at
        w1 = (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0
        w2 = a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a
        return jnp.where(at < 1.0, w1, jnp.where(at < 2.0, w2, 0.0))

    x0 = jnp.floor(sx).astype(jnp.int32)
    y0 = jnp.floor(sy).astype(jnp.int32)
    fx = sx - x0
    fy = sy - y0
    val = jnp.zeros_like(sx)
    wsum = jnp.zeros_like(sx)
    for dy in range(-1, 3):
        wy = keys(fy - dy)
        for dx in range(-1, 3):
            wx = keys(fx - dx)
            v, m = fetch(y0 + dy, x0 + dx)
            wgt = wx * wy * m
            val = val + v * wgt
            wsum = wsum + wgt
    return jnp.where(wsum > 1e-6, val / jnp.maximum(wsum, 1e-20), 0.0)


@functools.partial(jax.jit, static_argnames=("out_rows", "out_cols", "method"))
def _warp_sample(src, map_x, map_y, out_rows: int, out_cols: int, method: str):
    """Device pass: upsample the mapping grid to every output pixel and
    gather-sample the source. One fused program; out-of-bounds → 0."""
    return _warp_sample_block(src, map_x, map_y, out_rows, out_cols, method,
                              jnp.int32(0), out_rows)


@dataclasses.dataclass
class WarpPlan:
    """Host-side warp plan: output grid + coarse f64 inverse-mapping grid.

    Exposed separately from `warp_to_crs` so the grid-interpolation error
    (the role of GDAL's approximate-transformer tolerance, default 0.125 px)
    can be bounded against the exact f64 mapping without re-deriving the
    plan's construction (tests/test_warp.py)."""

    out_cols: int
    out_rows: int
    geotransform: list[float]
    dst_epsg: int
    method: str
    mapping: "_SourceMapping"
    map_x: np.ndarray  # (gh, gw) source col (pixel-center) per grid node
    map_y: np.ndarray  # (gh, gw) source row

    def exact_source_pixels(self, out_cols_f: np.ndarray, out_rows_f: np.ndarray):
        """f64 target pixel → source pixel (pixel-center), no interpolation."""
        gt = self.geotransform
        tx = gt[0] + (np.asarray(out_cols_f, np.float64) + 0.5) * gt[1]
        ty = gt[3] + (np.asarray(out_rows_f, np.float64) + 0.5) * gt[5]
        lon, lat = geodesy.project_inverse(tx, ty, self.dst_epsg)
        scol, srow = self.mapping.lonlat_to_pixels(lon, lat)
        return np.asarray(scol, np.float64) - 0.5, np.asarray(srow, np.float64) - 0.5

    def interp_source_pixels(self, out_cols_f: np.ndarray, out_rows_f: np.ndarray):
        """Bilinear interpolation of the coarse grid — exactly what the device
        sampler computes for each output pixel (cf. _warp_sample.interp)."""
        gh, gw = self.map_x.shape
        gr = np.asarray(out_rows_f, np.float64) * ((gh - 1) / max(self.out_rows - 1, 1))
        gc = np.asarray(out_cols_f, np.float64) * ((gw - 1) / max(self.out_cols - 1, 1))
        gr0 = np.clip(np.floor(gr), 0, gh - 2).astype(np.int64)
        gc0 = np.clip(np.floor(gc), 0, gw - 2).astype(np.int64)
        fr = gr - gr0
        fc = gc - gc0

        def interp(grid):
            i00 = grid[gr0, gc0]
            i01 = grid[gr0, gc0 + 1]
            i10 = grid[gr0 + 1, gc0]
            i11 = grid[gr0 + 1, gc0 + 1]
            return ((i00 * (1 - fc) + i01 * fc) * (1 - fr)
                    + (i10 * (1 - fc) + i11 * fc) * fr)

        return interp(self.map_x), interp(self.map_y)


def plan_warp(reader, target_crs: str, resample_alg: Optional[str] = None,
              target_size: Optional[int] = None,
              geolocation_grid: Optional[np.ndarray] = None) -> WarpPlan:
    """Host planning half of the warp (steps 1-3 of the module docstring)."""
    dst_epsg = geodesy.parse_epsg_code(target_crs)
    dst_kind = None if dst_epsg is None else geodesy.epsg_kind(dst_epsg)
    if dst_kind is None:
        reason = (geodesy.unsupported_reason(dst_epsg)
                  if dst_epsg is not None else None)
        why = f" ({reason})" if reason else ""
        raise ProcessingError(
            f"unsupported target CRS: {target_crs}{why}; supported: "
            f"{geodesy.SUPPORTED_CRS_FAMILIES}"
        )
    method = _resample_name(resample_alg)

    mapping = _SourceMapping(reader, geolocation_grid)
    if dst_kind.get("dynamic"):
        # late-bind the area-specific datum op for the scene's location,
        # like cs2cs/gdalwarp do per point
        clon, clat = mapping.pixels_to_lonlat(
            np.asarray([reader.metadata.size_x / 2.0]),
            np.asarray([reader.metadata.size_y / 2.0]))
        geodesy.refine_dynamic_crs_area(
            dst_epsg, float(np.ravel(clon)[0]), float(np.ravel(clat)[0]))
    src_cols = reader.metadata.size_x
    src_rows = reader.metadata.size_y
    out_cols, out_rows, gt = _suggest_output_grid(
        mapping, src_cols, src_rows, dst_epsg, target_size
    )
    logger.info("Warp output: %dx%d in EPSG:%d (%s)", out_cols, out_rows,
                dst_epsg, method)

    # coarse inverse-mapping grid (host f64 → f32 for the device)
    gh = min(out_rows // GRID_STEP + 2, MAX_GRID)
    gw = min(out_cols // GRID_STEP + 2, MAX_GRID)
    gy = np.linspace(0.0, out_rows - 1.0, gh)
    gx = np.linspace(0.0, out_cols - 1.0, gw)
    gxx, gyy = np.meshgrid(gx, gy)
    # target pixel center → target CRS coords
    tx = gt[0] + (gxx + 0.5) * gt[1]
    ty = gt[3] + (gyy + 0.5) * gt[5]
    lon, lat = geodesy.project_inverse(tx, ty, dst_epsg)
    scol, srow = mapping.lonlat_to_pixels(lon, lat)
    # pixel-center convention for sampling
    map_x = np.asarray(scol, np.float64) - 0.5
    map_y = np.asarray(srow, np.float64) - 0.5
    return WarpPlan(out_cols=out_cols, out_rows=out_rows, geotransform=gt,
                    dst_epsg=dst_epsg, method=method, mapping=mapping,
                    map_x=map_x, map_y=map_y)


def two_stage_plan(plan: WarpPlan, src_cols: int, src_rows: int):
    """Two-stage pre-reduce decision for strong-reduction warps.

    Returns None (sample the full-resolution source directly), or
    `(mid_rows, mid_cols, map_x, map_y)`: the area-average intermediate size
    (~1.25x the output resolution) and the plan's inverse mapping rescaled
    from source pixels into intermediate pixels (pixel-center convention:
    centers map by the size ratio). Pre-downsampling anti-aliases (gdalwarp's
    `-ts` path samples full-res and aliases) and shrinks the sampling working
    set ahead of the sampler."""
    # nan-aware: proj_pipe targets can leave out-of-domain grid nodes nan
    with np.errstate(invalid="ignore"):
        sx_est = ((np.nanmax(plan.map_x) - np.nanmin(plan.map_x) + 1)
                  / max(plan.out_cols, 1))
        sy_est = ((np.nanmax(plan.map_y) - np.nanmin(plan.map_y) + 1)
                  / max(plan.out_rows, 1))
    scale_est = max(
        sx_est if np.isfinite(sx_est) else 1.0,
        sy_est if np.isfinite(sy_est) else 1.0,
        1.0,
    )
    if scale_est < 2.0:
        return None
    factor = scale_est / 1.25
    mid_rows = max(int(np.ceil(src_rows / factor)), 1)
    mid_cols = max(int(np.ceil(src_cols / factor)), 1)
    ry = mid_rows / src_rows
    rx = mid_cols / src_cols
    map_x = (plan.map_x + 0.5) * rx - 0.5
    map_y = (plan.map_y + 0.5) * ry - 0.5
    return mid_rows, mid_cols, map_x, map_y


def warp_to_crs(reader, target_crs: str, resample_alg: Optional[str] = None,
                target_size: Optional[int] = None,
                geolocation_grid: Optional[np.ndarray] = None) -> WarpResult:
    """Reproject a raster to `target_crs` (EPSG:XXXX), the on-device
    equivalent of the reference's gdalwarp invocation (sentinel1.rs:988-1071)."""
    plan = plan_warp(reader, target_crs, resample_alg, target_size,
                     geolocation_grid)
    out_cols, out_rows = plan.out_cols, plan.out_rows
    gt, method = plan.geotransform, plan.method
    map_x, map_y = plan.map_x, plan.map_y
    src_cols = reader.metadata.size_x
    src_rows = reader.metadata.size_y

    # Two-stage warp for strong reductions (see two_stage_plan). The
    # pre-reduce runs ON THE HOST through the reader's native single-pass
    # box reducer (read_band_resampled, the same windows the device resampler
    # builds) — the source bytes are touched once from disk and only the
    # ~1.25x-output intermediate ships to the device, instead of materializing and
    # transferring the full-resolution f32 raster (3.2 GB for a 400 MP pair).
    # This makes the with-warp read stage cost what the no-warp
    # downsample-on-read stage costs (the reference pays a full gdalwarp VRT
    # pass here, sentinel1.rs:988-1071).
    two = two_stage_plan(plan, src_cols, src_rows)
    if two is not None:
        mid_rows, mid_cols, map_x, map_y = two
        # host-side streaming reduce straight from disk; falls back to a
        # full read + device resample inside read_band_resampled* when the
        # native reducer or the layout does not apply (identical windows
        # either way — raster.py _average_windows uses the device
        # resampler's own coefficient builder)
        src = reader.read_band_resampled_to_device(1, mid_cols, mid_rows,
                                                   "average")
        logger.info("Warp two-stage: source %dx%d -> %dx%d (host reduce) "
                    "before sampling", src_cols, src_rows, mid_cols, mid_rows)
    else:
        src = jnp.asarray(reader.read_band(1))

    data = None
    mesh = _shard_mesh()
    if mesh is not None:
        from ..parallel.warp import warp_sample_sharded

        data = warp_sample_sharded(src, map_x, map_y, out_rows, out_cols,
                                   method, mesh)
    if data is None:
        data = _warp_sample(
            src,
            jnp.asarray(map_x, jnp.float32),
            jnp.asarray(map_y, jnp.float32),
            out_rows, out_cols, method,
        )
    projection = geodesy.epsg_to_wkt(plan.dst_epsg) or f"EPSG:{plan.dst_epsg}"
    return WarpResult(data=data, geotransform=gt, projection=projection,
                      epsg=plan.dst_epsg)
