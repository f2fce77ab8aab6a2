"""Sentinel-1 SAFE archive reader.

Parity with the reference's `SafeReader` (src/io/sentinel1.rs:114-1604):
directory validation, manifest.safe + annotation XML metadata extraction,
polarization file discovery (with `_warped` skip and single-file inference),
per-hint loading (vv|vh|hh|hv|multiband|vv_vh_pair|hh_hv_pair|all_pairs),
optional reprojection to a target CRS, downsample-on-read, batch-tolerant
`open_with_warnings*` variants returning None to skip, and the dual-pol
operation accessors.

Device-first departures from the reference:
  * reprojection runs as an on-device gather warp (io/warp.py) instead of a
    `gdalwarp` subprocess (reference: sentinel1.rs:988-1071);
  * downsample-on-read resampling executes on-device from the host-streamed
    raster (reference uses GDAL RasterIO decimation, sentinel1.rs:1073-1109);
  * loaded bands are jax device arrays (f32), resident in HBM.
"""
from __future__ import annotations

import contextvars
import dataclasses
import datetime
import functools
import logging
import xml.etree.ElementTree as ET
from enum import Enum
from pathlib import Path
from typing import Optional

import numpy as np

from .. import __version__ as _VERSION
from ..errors import SafeMissingField, SafeParseError, UnsupportedProduct
from . import geodesy
from .raster import RasterReader

logger = logging.getLogger("sarpro")

# When set (per-thread), downsample-on-read returns host numpy instead of
# enqueuing device transfers — the batch driver's loader threads use this
# so all device traffic stays ordered on the consumer thread.
DEFER_DEVICE_PUT: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "sarpro_defer_device_put", default=False)

SPEED_OF_LIGHT = 299_792_458.0


class TargetCrsArg(Enum):
    """Deferred 'auto' resolution (reference: sentinel1.rs:44-49)."""

    NONE = "none"
    AUTO = "auto"

    @staticmethod
    def custom(value: str) -> str:
        return value


@dataclasses.dataclass
class SafeMetadata:
    """~40 fields of product metadata (reference: sentinel1.rs:53-111)."""

    # Basic product information
    instrument: str = ""
    platform: str = ""
    acquisition_start: str = ""
    acquisition_stop: str = ""
    orbit_number: int = 0
    polarizations: list[str] = dataclasses.field(default_factory=list)
    lines: int = 0
    samples: int = 0
    product_type: str = ""
    # SAR parameters
    range_sampling_rate: Optional[float] = None
    radar_frequency: Optional[float] = None
    prf: Optional[float] = None
    tx_pulse_length: Optional[float] = None
    tx_pulse_ramp_rate: Optional[float] = None
    velocity: Optional[float] = None
    slant_range_near: Optional[float] = None
    # Georeferencing
    geotransform: Optional[list[float]] = None
    projection: Optional[str] = None
    crs: Optional[str] = None
    pixel_spacing_range: Optional[float] = None
    pixel_spacing_azimuth: Optional[float] = None
    # annotation geolocationGridPointList as (N,4) [pixel, line, lon, lat];
    # TPS control-point source when the measurement TIFF carries no GCPs
    geolocation_grid: Optional[np.ndarray] = None
    # Acquisition details
    instrument_mode: Optional[str] = None
    pass_direction: Optional[str] = None
    data_take_id: Optional[str] = None
    product_id: Optional[str] = None
    # Processing parameters
    processing_level: Optional[str] = None
    multilook_factor: Optional[int] = None
    calibration_type: Optional[str] = None
    noise_estimate: Optional[float] = None
    processing_center: Optional[str] = None
    software_version: Optional[str] = None
    # Image characteristics
    pixel_data_type: Optional[str] = None
    bits_per_sample: Optional[int] = None
    sample_format: Optional[str] = None
    # Additional SAR-specific
    incidence_angle: Optional[float] = None
    look_angle: Optional[float] = None
    doppler_centroid: Optional[float] = None
    radiometric_calibration: Optional[str] = None
    geometric_calibration: Optional[str] = None
    # Conversion provenance
    conversion_tool: str = "SARPRO"
    conversion_version: str = _VERSION
    conversion_timestamp: str = ""

    def copy(self) -> "SafeMetadata":
        return dataclasses.replace(
            self, polarizations=list(self.polarizations),
            geotransform=list(self.geotransform) if self.geotransform else None,
        )


def _localname(tag: str) -> str:
    """Strip XML namespace; the reference's quick-xml matcher keys on the
    written tag names (sentinel1.rs:1195-1273)."""
    if "}" in tag:
        tag = tag.split("}", 1)[1]
    if ":" in tag:
        tag = tag.split(":", 1)[1]
    return tag


def parse_manifest_safe(path: Path, meta: SafeMetadata) -> SafeMetadata:
    """Streaming state machine over manifest.safe sections
    (reference: sentinel1.rs:1176-1281)."""
    sections = {
        "platform": False, "acquisitionPeriod": False, "orbitReference": False,
        "facility": False, "software": False,
        "standAloneProductInformation": False, "orbitProperties": False,
    }
    curr = ""
    try:
        for event, elem in ET.iterparse(str(path), events=("start", "end")):
            tag = _localname(elem.tag)
            if event == "start":
                curr = tag
                if tag in sections:
                    sections[tag] = True
                continue
            # end event: elem.text is complete
            txt = (elem.text or "").strip()
            if txt:
                if tag == "familyName" and sections["platform"]:
                    meta.platform = txt
                elif tag == "instrument" and sections["platform"]:
                    meta.instrument = txt
                elif tag == "mode" and sections["platform"]:
                    meta.instrument_mode = txt
                elif tag == "startTime" and sections["acquisitionPeriod"]:
                    meta.acquisition_start = txt
                elif tag == "stopTime" and sections["acquisitionPeriod"]:
                    meta.acquisition_stop = txt
                elif tag == "orbitNumber" and sections["orbitReference"]:
                    try:
                        meta.orbit_number = int(txt)
                    except ValueError:
                        meta.orbit_number = 0
                elif tag == "pass" and sections["orbitProperties"]:
                    meta.pass_direction = txt
                elif tag == "productType" and sections["standAloneProductInformation"]:
                    meta.product_type = txt
                elif tag == "missionDataTakeID" and sections["standAloneProductInformation"]:
                    meta.data_take_id = txt
                elif tag == "productClass" and sections["standAloneProductInformation"]:
                    meta.processing_level = txt
                elif tag == "transmitterReceiverPolarisation" and sections["standAloneProductInformation"]:
                    meta.polarizations.append(txt)
                elif tag == "name" and sections["facility"]:
                    meta.processing_center = txt
                elif tag == "name" and sections["software"]:
                    meta.software_version = txt
                elif tag == "version" and sections["software"]:
                    meta.software_version = txt
            if tag in sections:
                sections[tag] = False
            elem.clear()
    except ET.ParseError as e:
        raise SafeParseError(f"manifest.safe parse error: {e}") from e
    return meta


def parse_annotation_xml(path: Path, meta: SafeMetadata) -> SafeMetadata:
    """Annotation XML state machine (reference: sentinel1.rs:1297-1442)."""
    in_ = {
        "adsHeader": False, "productInformation": False,
        "downlinkInformation": False, "downlinkValues": False,
        "orbitStateVector": False, "imageAnnotation": False,
        "geolocationGridPoint": False,
    }
    downlink_done = 0
    state_vectors: list[tuple[float, float, float]] = []
    current = [0.0, 0.0, 0.0]
    gg_points: list[tuple[float, float, float, float]] = []
    gg_current: dict[str, float] = {}
    try:
        for event, elem in ET.iterparse(str(path), events=("start", "end")):
            tag = _localname(elem.tag)
            if event == "start":
                if tag == "downlinkInformation":
                    if downlink_done == 0:
                        in_["downlinkInformation"] = True
                elif tag in in_:
                    in_[tag] = True
                continue
            txt = (elem.text or "").strip()

            def fget(t=txt):
                try:
                    return float(t)
                except ValueError:
                    return None

            if txt:
                if in_["adsHeader"]:
                    if tag == "missionId":
                        meta.platform = txt
                    elif tag == "productType":
                        meta.product_type = txt
                    elif tag == "polarisation":
                        meta.polarizations.append(txt)
                    elif tag == "mode":
                        meta.instrument_mode = txt
                    elif tag == "startTime":
                        meta.acquisition_start = txt
                    elif tag == "stopTime":
                        meta.acquisition_stop = txt
                    elif tag == "absoluteOrbitNumber":
                        try:
                            meta.orbit_number = int(txt)
                        except ValueError:
                            meta.orbit_number = 0
                    elif tag == "missionDataTakeId":
                        meta.data_take_id = txt
                if in_["productInformation"]:
                    if tag == "pass":
                        meta.pass_direction = txt
                    elif tag == "rangeSamplingRate":
                        meta.range_sampling_rate = fget()
                    elif tag == "radarFrequency":
                        meta.radar_frequency = fget()
                if in_["downlinkInformation"] and tag == "prf" and meta.prf is None:
                    meta.prf = fget()
                if in_["downlinkValues"]:
                    if tag == "txPulseLength" and meta.tx_pulse_length is None:
                        meta.tx_pulse_length = fget()
                    elif tag == "txPulseRampRate" and meta.tx_pulse_ramp_rate is None:
                        meta.tx_pulse_ramp_rate = fget()
                if in_["imageAnnotation"]:
                    if tag == "slantRangeTime" and meta.slant_range_near is None:
                        srt = fget() or 0.0
                        meta.slant_range_near = srt * SPEED_OF_LIGHT / 2.0
                    elif tag == "rangePixelSpacing":
                        meta.pixel_spacing_range = fget()
                    elif tag == "azimuthPixelSpacing":
                        meta.pixel_spacing_azimuth = fget()
                if in_["orbitStateVector"]:
                    if tag == "vx":
                        current[0] = fget() or 0.0
                    elif tag == "vy":
                        current[1] = fget() or 0.0
                    elif tag == "vz":
                        current[2] = fget() or 0.0
                if in_["geolocationGridPoint"] and tag in (
                        "pixel", "line", "longitude", "latitude"):
                    v = fget()
                    if v is not None:
                        gg_current[tag] = v
                # image dimensions — matched anywhere (reference: :1421-1424)
                if tag == "lines":
                    try:
                        meta.lines = int(txt)
                    except ValueError:
                        pass
                elif tag in ("samplesPerLine", "numberOfSamples"):
                    try:
                        meta.samples = int(txt)
                    except ValueError:
                        pass
            # end-of-section bookkeeping
            if tag == "downlinkInformation" and in_["downlinkInformation"]:
                in_["downlinkInformation"] = False
                downlink_done += 1
            elif tag == "orbitStateVector":
                in_["orbitStateVector"] = False
                state_vectors.append(tuple(current))
                current = [0.0, 0.0, 0.0]
            elif tag == "geolocationGridPoint":
                in_["geolocationGridPoint"] = False
                if all(k in gg_current
                       for k in ("pixel", "line", "longitude", "latitude")):
                    gg_points.append((gg_current["pixel"], gg_current["line"],
                                      gg_current["longitude"],
                                      gg_current["latitude"]))
                gg_current = {}
            elif tag in in_:
                in_[tag] = False
            elem.clear()
    except ET.ParseError as e:
        raise SafeParseError(f"annotation parse error: {e}") from e
    if state_vectors:
        vx, vy, vz = state_vectors[len(state_vectors) // 2]
        meta.velocity = float(np.sqrt(vx * vx + vy * vy + vz * vz))
    if gg_points and meta.geolocation_grid is None:
        meta.geolocation_grid = np.asarray(gg_points, np.float64)
    return meta


def _parse_comprehensive(base: Path) -> SafeMetadata:
    meta = SafeMetadata(
        conversion_timestamp=datetime.datetime.now(datetime.timezone.utc).isoformat()
    )
    manifest = base / "manifest.safe"
    if manifest.exists():
        meta = parse_manifest_safe(manifest, meta)
    annotation = base / "annotation"
    if annotation.is_dir():
        for p in sorted(annotation.iterdir()):
            if p.suffix == ".xml":
                meta = parse_annotation_xml(p, meta)
    return meta


@functools.lru_cache(maxsize=32)
def _parse_comprehensive_cached(base_str: str, _stamp) -> SafeMetadata:
    return _parse_comprehensive(Path(base_str))


def parse_comprehensive_metadata(base: Path) -> SafeMetadata:
    """manifest.safe + annotation files (reference: sentinel1.rs:1114-1174).

    Memoized on (path, manifest/annotation mtimes): the batch paths run the
    metadata-only viability check (api.scene_skip_reason) and then open the
    product, which would otherwise parse every annotation XML twice per
    scene. Callers get a defensive copy — downstream loaders mutate the
    geotransform/dims fields."""
    base = Path(base)
    try:
        stamp = (
            (base / "manifest.safe").stat().st_mtime_ns,
            (base / "annotation").stat().st_mtime_ns,
        )
    except OSError:
        return _parse_comprehensive(base)
    return _parse_comprehensive_cached(str(base), stamp).copy()


def identify_polarization_files(measurement: Path, available: list[str]):
    """Find per-pol measurement TIFFs by filename substring, with `_warped`
    skip and single-file inference fallback (reference: sentinel1.rs:799-882)."""
    vv = vh = hh = hv = None
    for path in sorted(measurement.iterdir()):
        name = path.name.lower()
        if not (name.endswith(".tiff") or name.endswith(".tif")):
            continue
        if "_warped.tif" in name or "_warped.tiff" in name:
            continue
        if "vv" in name:
            vv = path
            logger.info("Found VV file: %s", path)
        elif "vh" in name:
            vh = path
            logger.info("Found VH file: %s", path)
        elif "hh" in name:
            hh = path
            logger.info("Found HH file: %s", path)
        elif "hv" in name:
            hv = path
            logger.info("Found HV file: %s", path)
    if vv is None and vh is None and hh is None and hv is None:
        logger.info("No polarization-specific files found; inferring from "
                    "available polarizations: %s", available)
        for path in sorted(measurement.iterdir()):
            if path.suffix.lower() not in (".tiff", ".tif"):
                continue
            for pol in available:
                p = pol.lower()
                if p == "vv":
                    vv = path
                    break
                if p == "vh":
                    vh = path
                    break
                if p == "hh":
                    hh = path
                    break
            if vv or vh or hh:
                break
    return vv, vh, hh, hv


class SafeReader:
    """Reader for Sentinel-1 SAFE archives (reference: sentinel1.rs:114-122)."""

    def __init__(self, base_path: Path, metadata: SafeMetadata, product_type: str,
                 vv=None, vh=None, hh=None, hv=None):
        self.base_path = base_path
        self.metadata = metadata
        self.product_type = product_type
        self._vv = vv
        self._vh = vh
        self._hh = hh
        self._hv = hv
        # device-resident first-band program output from an overlapped pair
        # load (see open_with_options band_stage); None unless staged
        self.staged_band1 = None

    # -- opening --------------------------------------------------------------
    @classmethod
    def open(cls, safe_dir, polarization: Optional[str] = None) -> "SafeReader":
        return cls.open_with_options(safe_dir, polarization, None, None, None)

    @classmethod
    def open_with_options(
        cls,
        safe_dir,
        polarization: Optional[str] = None,
        target_crs=None,
        resample_alg: Optional[str] = None,
        target_size: Optional[int] = None,
        band_stage=None,
    ) -> "SafeReader":
        """reference: sentinel1.rs:134-400.

        `band_stage` (optional callable, fast file path): applied to the
        FIRST band of a pair load as soon as it is read, overlapping its
        device program with the second band's disk read; the staged result
        is exposed as `reader.staged_band1`."""
        return cls._open(safe_dir, polarization, target_crs, resample_alg,
                         target_size, warnings_mode=False,
                         band_stage=band_stage)

    @classmethod
    def open_with_warnings(cls, safe_dir, polarization: Optional[str] = None):
        """Batch-tolerant open: returns None to skip unsupported products
        (reference: sentinel1.rs:404-589)."""
        return cls._open(safe_dir, polarization, None, None, None, warnings_mode=True)

    @classmethod
    def open_with_warnings_with_options(
        cls, safe_dir, polarization=None, target_crs=None,
        resample_alg: Optional[str] = None, target_size: Optional[int] = None,
    ):
        """reference: sentinel1.rs:592-796."""
        return cls._open(safe_dir, polarization, target_crs, resample_alg,
                         target_size, warnings_mode=True)

    @classmethod
    def _open(cls, safe_dir, polarization, target_crs, resample_alg,
              target_size, warnings_mode: bool, band_stage=None):
        base = Path(safe_dir)
        annotation = base / "annotation"
        measurement = base / "measurement"
        if not annotation.is_dir():
            raise SafeMissingField("annotation directory")
        if not measurement.is_dir():
            raise SafeMissingField("measurement directory")

        metadata = parse_comprehensive_metadata(base)

        logger.info("Detecting product type from metadata")
        if metadata.product_type.upper() != "GRD":
            if warnings_mode:
                logger.warning("Skipping unsupported product type: %s (file: %s)",
                               metadata.product_type, base)
                return None
            raise UnsupportedProduct(metadata.product_type)

        logger.info("Identifying polarization files")
        vv_path, vh_path, hh_path, hv_path = identify_polarization_files(
            measurement, metadata.polarizations
        )

        # Resolve effective target CRS exactly once per product
        # (reference: sentinel1.rs:169-175)
        if isinstance(target_crs, str):
            effective_crs: Optional[str] = target_crs
        elif target_crs is TargetCrsArg.AUTO:
            effective_crs = geodesy.resolve_auto_target_crs(base)
        else:  # None or TargetCrsArg.NONE
            effective_crs = None

        def load(path):
            return cls._load_polarization_data_with_options(
                path, metadata, effective_crs, resample_alg, target_size
            )

        staged_cell = [None]

        def load_pair(p1, p2, stage: bool = True):
            """Overlap the two band loads: disk readahead / strip decode /
            host reduce / device transfer of one band proceed while the
            other computes (the loads release the GIL in I/O and native
            code). Both loads write identical geometry into `metadata`, so
            the concurrent mutation is benign.

            With `band_stage` set (the fast file path's per-band device
            program), the first band is handed to it from THIS thread as
            soon as its load lands — the async dispatch returns immediately
            and the device chews band 1 while band 2 is still streaming off
            disk (intra-scene stage overlap)."""
            import concurrent.futures
            import contextvars

            # context vars (DEFER_DEVICE_PUT, the warp's SHARD_DEVICES) do
            # NOT propagate into pool worker threads by default — copy the
            # caller's context per task, or batch loaders would enqueue
            # device transfers and --shard-devices would silently skip the
            # warp for dual-pol scenes
            with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
                f1 = ex.submit(contextvars.copy_context().run, load, p1)
                f2 = ex.submit(contextvars.copy_context().run, load, p2)
                a1 = f1.result()
                if stage and band_stage is not None and a1 is not None:
                    staged_cell[0] = band_stage(a1)
                return a1, f2.result()

        def missing(what):
            if warnings_mode:
                logger.warning("%s measurement file not found, skipping product", what)
                return None
            raise SafeMissingField(f"{what} measurement file")

        vv = vh = hh = hv = None
        pol = polarization
        if pol in ("vv", None):
            metadata.polarizations = ["VV"]
            if vv_path is None:
                return missing("VV")
            vv = load(vv_path)
        elif pol == "vh":
            metadata.polarizations = ["VH"]
            if vh_path is None:
                return missing("VH")
            vh = load(vh_path)
        elif pol == "hh":
            metadata.polarizations = ["HH"]
            if hh_path is None:
                return missing("HH")
            hh = load(hh_path)
        elif pol == "hv":
            metadata.polarizations = ["HV"]
            if hv_path is None:
                return missing("HV")
            hv = load(hv_path)
        elif pol == "multiband":
            # polarizations list left as parsed (reference: :248-275)
            if vv_path is None:
                return missing("VV")
            if vh_path is None:
                return missing("VH")
            vv, vh = load_pair(vv_path, vh_path)
        elif pol == "vv_vh_pair":
            metadata.polarizations = ["VV", "VH"]
            if vv_path is None:
                return missing("VV")
            if vh_path is None:
                return missing("VH")
            vv, vh = load_pair(vv_path, vh_path)
        elif pol == "hh_hv_pair":
            metadata.polarizations = ["HH", "HV"]
            if hh_path is None:
                return missing("HH")
            if hv_path is None:
                return missing("HV")
            hh, hv = load_pair(hh_path, hv_path)
        elif pol == "all_pairs":
            metadata.polarizations = ["VV", "VH", "HH", "HV"]
            # complete pairs load OVERLAPPED (this is the hint the file API
            # uses for multiband, so the fast path's band-1 staging rides
            # here); band_stage applies to the pair multiband save prefers
            # (VV+VH when present, else HH+HV — api._band_pair's order)
            if vv_path is not None and vh_path is not None:
                vv, vh = load_pair(vv_path, vh_path)
            else:
                if vv_path is not None:
                    vv = load(vv_path)
                if vh_path is not None:
                    vh = load(vh_path)
            if hh_path is not None and hv_path is not None:
                hh, hv = load_pair(hh_path, hv_path,
                                   stage=vv is None or vh is None)
            else:
                if hh_path is not None:
                    hh = load(hh_path)
                if hv_path is not None:
                    hv = load(hv_path)
        else:
            if warnings_mode:
                logger.warning("Unsupported polarization: %s, skipping product", pol)
                return None
            raise SafeParseError(f"Unsupported polarization: {pol}")

        reader = cls(base, metadata, "GRD", vv, vh, hh, hv)
        reader.staged_band1 = staged_cell[0]
        return reader

    # -- loading --------------------------------------------------------------
    @staticmethod
    def _load_polarization_data(file_path: Path, metadata: SafeMetadata):
        """Full-resolution load (reference: sentinel1.rs:885-911).

        Honors DEFER_DEVICE_PUT (host numpy out) like the decimated path —
        batch loader threads must not enqueue device transfers. The warp
        branch is the one exception: the warp itself computes on device, so
        warped batch scenes inherently dispatch from the loader."""
        import jax.numpy as jnp

        logger.info("Loading underlying data from: %s", file_path)
        reader = RasterReader(file_path)
        metadata.geotransform = list(reader.metadata.geotransform)
        metadata.projection = reader.metadata.projection
        metadata.crs = reader.metadata.projection
        arr = reader.read_band(1)
        metadata.lines, metadata.samples = arr.shape
        reader.close()
        if DEFER_DEVICE_PUT.get():
            return arr
        return jnp.asarray(arr)

    @classmethod
    def _load_polarization_data_with_options(
        cls, file_path: Path, metadata: SafeMetadata,
        target_crs: Optional[str], resample_alg: Optional[str],
        target_size: Optional[int],
    ):
        """Warp / downsample-on-read / full read (reference: sentinel1.rs:914-1112)."""
        import jax.numpy as jnp

        if target_crs:
            from . import warp as warp_mod

            logger.info("Warping to target CRS: %s", target_crs)
            reader = RasterReader(file_path)
            # skip-warp guard when already in target CRS (reference: :959-986)
            ds_epsg = reader.metadata.epsg
            dst_epsg = geodesy.parse_epsg_code(target_crs)
            if ds_epsg is not None and dst_epsg is not None and ds_epsg == dst_epsg:
                logger.info("Input already in target CRS (%s); skipping warp", target_crs)
                metadata.geotransform = list(reader.metadata.geotransform)
                metadata.projection = reader.metadata.projection
                metadata.crs = reader.metadata.projection
                arr = reader.read_band(1)
                metadata.lines, metadata.samples = arr.shape
                reader.close()
                return arr if DEFER_DEVICE_PUT.get() else jnp.asarray(arr)
            result = warp_mod.warp_to_crs(
                reader, target_crs,
                resample_alg=resample_alg or "bilinear",
                target_size=target_size,
                geolocation_grid=metadata.geolocation_grid,
            )
            reader.close()
            metadata.geotransform = list(result.geotransform)
            metadata.projection = result.projection
            metadata.crs = result.projection
            metadata.lines, metadata.samples = result.data.shape
            return result.data

        if target_size is not None:
            logger.info("Reading at target size (long side): %d", target_size)
            reader = RasterReader(file_path)
            metadata.geotransform = list(reader.metadata.geotransform)
            metadata.projection = reader.metadata.projection
            metadata.crs = reader.metadata.projection
            orig_cols = reader.metadata.size_x
            orig_rows = reader.metadata.size_y
            long_side = max(orig_cols, orig_rows)
            scale = min(target_size / long_side, 1.0)
            out_cols = max(int(np.floor(orig_cols * scale + 0.5)), 1)
            out_rows = max(int(np.floor(orig_rows * scale + 0.5)), 1)
            # Average for heavy downscale (>=4x), Lanczos otherwise, unless the
            # user picked a filter (reference: sentinel1.rs:1089-1102)
            reduction = max(long_side / target_size, 1.0)
            chosen = resample_alg or ("average" if reduction >= 4.0 else "lanczos")
            if DEFER_DEVICE_PUT.get():
                # batch loader threads stay host-only so that all device
                # traffic stays ordered on the consumer thread, which ships
                # the plane when it dispatches the scene
                arr = reader.read_band_resampled(1, out_cols, out_rows,
                                                 chosen)
                reader.close()
                metadata.lines, metadata.samples = out_rows, out_cols
                return arr
            # streams host→device copies per reduced chunk (overlaps decode
            # with transfer)
            dev = reader.read_band_resampled_to_device(1, out_cols, out_rows,
                                                       chosen)
            reader.close()
            metadata.lines, metadata.samples = out_rows, out_cols
            return dev

        return cls._load_polarization_data(file_path, metadata)

    # -- accessors ------------------------------------------------------------
    def data(self):
        """VV if available, else VH (reference: sentinel1.rs:1450-1458)."""
        if self._vv is not None:
            return self._vv
        if self._vh is not None:
            return self._vh
        raise SafeMissingField("no polarization data available")

    def vv_data(self):
        if self._vv is None:
            raise SafeMissingField("vv_data")
        return self._vv

    def vh_data(self):
        if self._vh is None:
            raise SafeMissingField("vh_data")
        return self._vh

    def hh_data(self):
        if self._hh is None:
            raise SafeMissingField("hh_data")
        return self._hh

    def hv_data(self):
        if self._hv is None:
            raise SafeMissingField("hv_data")
        return self._hv

    def has_vv(self):
        return self._vv is not None

    def has_vh(self):
        return self._vh is not None

    def has_hh(self):
        return self._hh is not None

    def has_hv(self):
        return self._hv is not None

    # dual-pol operation accessors (reference: sentinel1.rs:1497-1579)
    def _op(self, a, b, name):
        from ..core import ops

        logger.info("Computing %s", name)
        return ops.OPERATIONS[name](a, b)

    def sum_data(self):
        return self._op(self.vv_data(), self.vh_data(), "sum")

    def difference_data(self):
        return self._op(self.vv_data(), self.vh_data(), "diff")

    def ratio_data(self):
        return self._op(self.vv_data(), self.vh_data(), "ratio")

    def normalized_diff_data(self):
        return self._op(self.vv_data(), self.vh_data(), "n-diff")

    def log_ratio_data(self):
        return self._op(self.vv_data(), self.vh_data(), "log-ratio")

    def sum_hh_hv_data(self):
        return self._op(self.hh_data(), self.hv_data(), "sum")

    def difference_hh_hv_data(self):
        return self._op(self.hh_data(), self.hv_data(), "diff")

    def ratio_hh_hv_data(self):
        return self._op(self.hh_data(), self.hv_data(), "ratio")

    def normalized_diff_hh_hv_data(self):
        return self._op(self.hh_data(), self.hv_data(), "n-diff")

    def log_ratio_hh_hv_data(self):
        return self._op(self.hh_data(), self.hv_data(), "log-ratio")

    def get_available_polarizations(self) -> str:
        """reference: sentinel1.rs:1582-1603."""
        avail = []
        if self._vv is not None:
            avail.append("VV")
        if self._vh is not None:
            avail.append("VH")
        if self._hh is not None:
            avail.append("HH")
        if self._hv is not None:
            avail.append("HV")
        return ", ".join(avail) if avail else "none"
