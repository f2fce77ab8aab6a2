"""End-to-end (disk → device → file) benchmark for the headline config.

The reference's baselines are end-to-end wall times (BASELINE.md: 348.21 ms
for dual-band 400 MP GRD → 2048×2048 synRGB JPEG without warp, ~1.5 s with
auto-UTM reprojection, on a 12-core Apple M4 Pro). This module builds a
full-size synthetic SAFE on local disk (2× 20000×20000 u16 striped
contiguous TIFFs, the real S1 GRD layout, from a seed) and times the REAL
file pipeline (`api.process_safe_to_path(fast=True)` — the CLI's `--fast`
route) from disk to the written JPEG.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / ".bench"
SIDE = 20000  # 400 MP per band


def ensure_fullsize_safe(side: int = SIDE, seed: int = 11) -> Path:
    """Generate (once, cached) the full-size synthetic SAFE on disk."""
    name = f"S1A_IW_GRDH_1SDV_BENCH{side}.SAFE"
    base = DATA / name
    marker = base / ".complete"
    if marker.exists():
        return base
    sys.path.insert(0, str(REPO / "tests"))
    import fixtures

    DATA.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    # SAR-like lognormal DN, built from a (side/10, side) f32 block tiled
    # with row-rolls — full-size per-element lognormal would cost minutes.
    block_rows = -(-side // 10)
    print(f"[e2e] generating {name} (2x {side}x{side} u16)...", file=sys.stderr)

    def gen_band(mean: float) -> np.ndarray:
        blk = rng.lognormal(mean, 1.1, (block_rows, side)).astype(np.float32)
        np.clip(blk, 0, 65535, out=blk)
        blk16 = blk.astype(np.uint16)
        blk16[rng.random((block_rows, side)) < 0.01] = 0
        out = np.empty((side, side), np.uint16)
        for i in range(10):
            r0, r1 = i * block_rows, min((i + 1) * block_rows, side)
            out[r0:r1] = np.roll(blk16, 97 * i, axis=1)[:r1 - r0]
        return out

    base.mkdir(parents=True, exist_ok=True)
    (base / "annotation").mkdir(exist_ok=True)
    (base / "measurement").mkdir(exist_ok=True)
    pol_entries = "\n      ".join(
        "<s1sarl1:transmitterReceiverPolarisation>%s"
        "</s1sarl1:transmitterReceiverPolarisation>" % p for p in ("VV", "VH")
    )
    (base / "manifest.safe").write_text(
        fixtures.MANIFEST_TEMPLATE.format(
            product_type="GRD", pass_direction="ASCENDING",
            polarisation_entries=pol_entries,
        )
    )
    for pol, mean in (("vv", 5.0), ("vh", 4.2)):
        (base / "annotation" / f"s1a-iw-grd-{pol}-001.xml").write_text(
            fixtures.ANNOTATION_TEMPLATE.format(
                product_type="GRD", pol=pol.upper(),
                pass_direction="ASCENDING", samples=side, lines=side,
                geolocation_block="",
            )
        )
        fixtures._write_measurement_tiff(
            base / "measurement" / f"s1a-iw-grd-{pol}-001.tiff",
            gen_band(mean),
        )
    marker.write_text("ok")
    print(f"[e2e] generated in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return base


def run_e2e(runs: int = 5, strategy: str = "clahe") -> dict:
    """p50 end-to-end wall time of the real --fast CLI pipeline."""
    from sarpro_tpu import api
    from sarpro_tpu.params import ProcessingParams
    from sarpro_tpu.types import (
        AutoscaleStrategy, OutputFormat, Polarization,
    )

    base = ensure_fullsize_safe()
    out = DATA / f"e2e_{strategy}.jpg"
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy(strategy), size=2048, pad=True,
        # CLI default: unspecified → reader heuristic (Average for the 9.8x
        # reduction here), exactly the reference CLI's downsample-on-read
        resample_alg=None,
    )
    times = []
    for i in range(runs + 1):  # first run is warmup (jit compile)
        t0 = time.perf_counter()
        api.process_safe_to_path(base, out, params, fast=True)
        dt = (time.perf_counter() - t0) * 1000.0
        if i > 0:
            times.append(dt)
    return {
        "p50_ms": float(np.percentile(times, 50)),
        "times_ms": [round(t, 1) for t in times],
        "config": f"disk 400MP dual-pol SAFE -> 2048 {strategy} synRGB JPEG "
                  f"(--fast), pad",
    }


# ---------------------------------------------------------------------------
# With-warp arm — the reference's headline configuration (BASELINE.md:
# dual-band 400 MP GRD → 2048×2048 synRGB JPEG WITH reprojection + padding,
# Tamed autoscale, cubic resampling, ~1.5 s on the 12-core M4 Pro). The
# full-size bench SAFE carries the same 5×5 WGS84 GCP lattice real S1 GRD
# products do, so auto-CRS resolves a UTM zone and the warp runs the
# production TPS + two-stage host-reduce + gather-sampler path.
# ---------------------------------------------------------------------------

def run_e2e_warp(runs: int = 3) -> dict:
    """p50 wall of the real --fast with-warp pipeline."""
    from sarpro_tpu import api
    from sarpro_tpu.params import ProcessingParams
    from sarpro_tpu.types import AutoscaleStrategy, OutputFormat, Polarization

    base = ensure_fullsize_safe()
    out = DATA / "e2e_warp.jpg"
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.TAMED, size=2048, pad=True,
        target_crs="auto", resample_alg="cubic",
    )
    times = []
    for i in range(runs + 1):  # first run is warmup (jit compile)
        t0 = time.perf_counter()
        api.process_safe_to_path(base, out, params, fast=True)
        dt = (time.perf_counter() - t0) * 1000.0
        if i > 0:
            times.append(dt)
    return {
        "p50_ms": float(np.percentile(times, 50)),
        "times_ms": [round(t, 1) for t in times],
        "config": "disk 400MP dual-pol SAFE -> auto-UTM warp (cubic, TPS "
                  "from GCPs) -> 2048 tamed synRGB JPEG (--fast), pad",
    }


if __name__ == "__main__":
    print(json.dumps({"e2e": run_e2e(), "e2e_warp": run_e2e_warp()},
                     indent=2))
