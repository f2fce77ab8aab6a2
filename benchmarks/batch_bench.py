"""Batch throughput benchmark: serial vs pipelined drivers over N scenes.

The reference's batch loop is strictly serial (api/mod.rs:502-533: read,
process, write per product). The pipelined driver
(parallel/batch.py:process_directory_pipelined) prefetches scene reads on a
host thread so device compute overlaps the next scene's I/O, and with
fast=True defers encode+file-write to a dedicated writer thread so the
device starts scene N+1 while scene N encodes — the
inter-scene parallelism SURVEY.md §2.5 calls for. Both arms here run the
fused fast path, so the speedup isolates pipelining. This benchmark builds
N synthetic dual-pol SAFEs on disk and measures scenes/second through the
REAL directory APIs (everything included: SAFE parse, read+reduce, device,
JPEG write, sidecars).

Usage: python benchmarks/batch_bench.py [n_scenes] [side] [out_size]
Prints the measured walls as JSON, with the device they ran on. It refuses
to run on anything but a GPU.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

REPO = pathlib.Path(__file__).resolve().parent.parent
DATA = REPO / ".bench" / "batch"


def ensure_scenes(n: int, side: int) -> pathlib.Path:
    sys.path.insert(0, str(REPO / "tests"))
    import fixtures

    root = DATA / f"in_{n}x{side}"
    marker = root / ".complete"
    if marker.exists():
        return root
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for i in range(n):
        base = root / f"S1A_IW_GRDH_1SDV_2025071{i}T000000.SAFE"
        fixtures.make_safe(
            root, name=base.name, pols=("vv", "vh"), shape=(side, side),
            seed=int(rng.integers(0, 1 << 31)),
        )
    marker.write_text("ok")
    return root


def run(n_scenes: int = 6, side: int = 5000, out_size: int = 1024) -> dict:
    import jax

    from sarpro_tpu.utils.compilation_cache import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"batch_bench measures the GPU; JAX found "
                         f"{dev.platform!r}")
    enable_compilation_cache()
    from sarpro_tpu import api
    from sarpro_tpu.params import ProcessingParams
    from sarpro_tpu.parallel.batch import process_directory_pipelined
    from sarpro_tpu.types import AutoscaleStrategy, OutputFormat, Polarization

    indir = ensure_scenes(n_scenes, side)
    # resample_alg=None = the CLI's batch semantics (reader heuristic →
    # native average box reduce for the ≥4× reduction here). The
    # ProcessingParams DEFAULT ("lanczos", the reference API default) would
    # instead full-read and Lanczos-resample each band as a standalone
    # device program INSIDE the loader threads — slower everywhere and
    # device work where the pipelined loader must be host-only.
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.CLAHE, size=out_size, resample_alg=None,
    )

    arms = (
        ("serial", lambda out: api.process_directory_to_path(
            indir, out, params, fast=True)),
        ("pipelined_prefetch2", lambda out: process_directory_pipelined(
            indir, out, params, prefetch=2, fast=True, device_batch=1)),
        ("pipelined_devbatch3", lambda out: process_directory_pipelined(
            indir, out, params, prefetch=3, fast=True, device_batch=3)),
    )

    def run_arm(name, fn):
        out = DATA / f"out_{name}"
        if out.exists():
            shutil.rmtree(out)
        out.mkdir(parents=True)
        t0 = time.perf_counter()
        report = fn(out)
        return time.perf_counter() - t0, report

    # warmup both arms once (jit compile, page cache)
    for name, fn in arms:
        run_arm(name, fn)
    # interleaved repetitions, per-arm medians: slow drifts of the host
    # (page cache, clocks) hit every arm alike
    reps = 3
    walls = {name: [] for name, _ in arms}
    report_by = {}
    for _ in range(reps):
        for name, fn in arms:
            dt, report = run_arm(name, fn)
            walls[name].append(dt)
            report_by[name] = report
    results = {}
    for name, _ in arms:
        med = float(np.median(walls[name]))
        results[name] = {
            "wall_s_median": round(med, 2),
            "wall_s_all": [round(w, 2) for w in walls[name]],
            "scenes_per_s": round(n_scenes / med, 3),
            "processed": report_by[name].processed,
            "skipped": report_by[name].skipped,
            "errors": report_by[name].errors,
        }
    results["config"] = (f"{n_scenes} scenes, {side}x{side} dual-pol u16 -> "
                        f"{out_size} CLAHE synRGB JPEG (--fast), interleaved "
                        f"median of {reps}")
    results["speedup"] = round(
        results["pipelined_prefetch2"]["scenes_per_s"]
        / results["serial"]["scenes_per_s"], 2)
    results["speedup_devbatch"] = round(
        results["pipelined_devbatch3"]["scenes_per_s"]
        / results["serial"]["scenes_per_s"], 2)
    results["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())}
    return results


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    side = int(sys.argv[2]) if len(sys.argv) > 2 else 5000
    out_size = int(sys.argv[3]) if len(sys.argv) > 3 else 1024
    print(json.dumps(run(n, side, out_size), indent=2))
