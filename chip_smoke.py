#!/usr/bin/env python3
"""Smoke test of the SAR pipeline on NVIDIA GPUs, through the CLI.

    python chip_smoke.py               # one card: phases 1-6 below
    python chip_smoke.py --devices 4   # four cards: the multi-card paths only

One process drives the card(s); the only child process is a CPU-only JAX
(JAX_PLATFORMS=cpu) that never opens a card. Phases, one card:

  1. device report (refuses to run anywhere but on a GPU);
  2. build the native host codec from source;
  3. generate the real-size scene: 2x 20000x20000 u16 dual-pol IW GRD
     (400 MP per band, seeded), plus a 4000x4000 one for the CPU check;
  4. four CLI runs, each writing its file, timed warm (median of 3 after a
     warm-up) with compile time and peak device memory:
       a  --fast multiband CLAHE synRGB JPEG, 2048, pad
       b  a with auto-UTM reprojection, cubic, tamed autoscale
       c  exact mode, u16 TIFF, robust, 1024, lanczos (> 24-tap resampler)
       d  a at full resolution (the streamed big-scene path)
  5. correctness: a, b and d against the exact host-f64 path, c against
     the CPU backend's exact mode on the smaller scene, with a control run
     (the resampler contraction in TF32) that must fail c's limits;
  6. kernels at real sizes: the histograms (counts must equal numpy's),
     the lookups, the resampler and the warp sampler, then a profiler trace
     of run d and the `gpu`-marked tests.

With --devices 4: run d row-sharded over four cards (--shard-devices 4),
byte for byte against the one-card file, and four scenes through the
scene-batch mesh (--device-batch 4) against one-card per-scene files; the
mesh run must have sent all four scenes through one program on four cards.

Exits non-zero if any phase fails or no GPU is found. The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
WORK = REPO / ".bench"
OUT = WORK / "smoke_out"
SIDE = 20000       # 400 MP per band: the reference's documented scene
SMALL_SIDE = 4000  # the exact-mode scene the CPU backend also runs
SEED = 11
REPS = 3           # warm timed runs per configuration, after one warm-up


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="1: the one-card phases; 4: only the multi-card "
                         "paths and what they are compared with")
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. device report
# ---------------------------------------------------------------------------
def device_report(want: int) -> dict:
    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU; JAX found "
                         f"platform {dev.platform!r}")
    if len(devs) < want:
        raise SystemExit(f"chip_smoke: --devices {want} but JAX sees "
                         f"{len(devs)} GPU(s)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    log(f"jax {jax.__version__}: platform={dev.platform} "
        f"kind={dev.device_kind} count={len(devs)}")
    log(f"nvidia-smi: {smi}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devs), "card": card}


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------
def build() -> None:
    t0 = time.perf_counter()
    subprocess.run([sys.executable, str(REPO / "native" / "build.py")],
                   check=True, capture_output=True)
    from sarpro_tpu import _native

    if not _native.available():
        raise RuntimeError("native host codec did not load after building")
    log(f"build: native codec {time.perf_counter() - t0:.1f} s (set-up)")


# ---------------------------------------------------------------------------
# 3. data
# ---------------------------------------------------------------------------
def data(side: int) -> pathlib.Path:
    from benchmarks import e2e

    t0 = time.perf_counter()
    safe = e2e.ensure_fullsize_safe(side, seed=SEED)
    log(f"data: {safe.name} ready in {time.perf_counter() - t0:.1f} s "
        f"(set-up)")
    return safe


# ---------------------------------------------------------------------------
# 4. CLI runs
# ---------------------------------------------------------------------------
FAST_RGB = ["--fast", "-f", "jpeg", "--polarization", "multiband",
            "--autoscale", "clahe", "--size", "2048", "--pad"]
RUNS = {
    "a": (FAST_RGB, "jpg"),
    "b": (["--fast", "-f", "jpeg", "--polarization", "multiband",
           "--autoscale", "tamed", "--size", "2048", "--pad",
           "--target-crs", "auto", "--resample-alg", "cubic"], "jpg"),
    "c": (["--bit-depth", "u16", "--autoscale", "robust", "--size", "1024",
           "--resample-alg", "lanczos"], "tiff"),
    "d": (["--fast", "-f", "jpeg", "--polarization", "multiband",
           "--autoscale", "clahe"], "jpg"),
}


class CompileClock:
    """Sums JAX's compile-stage durations (tracing, lowering, XLA)."""

    def __init__(self):
        import jax.monitoring

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event.startswith("/jax/core/compile"):
            self.total += duration


def cli(args: list[str]) -> None:
    from sarpro_tpu import cli as sarpro_cli

    rc = sarpro_cli.run(args)
    if rc != 0:
        raise RuntimeError(f"sarpro CLI exited {rc}: {' '.join(args)}")


def timed_run(name: str, args: list[str], out: pathlib.Path, clock,
              card: str) -> dict:
    import jax

    argv = args + ["-o", str(out)]
    c0 = clock.total
    t0 = time.perf_counter()
    cli(argv)
    first = time.perf_counter() - t0
    compile_s = clock.total - c0
    walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        cli(argv)
        walls.append(time.perf_counter() - t0)
    if not out.exists() or out.stat().st_size == 0:
        raise RuntimeError(f"run {name} wrote no file")
    stats = jax.devices()[0].memory_stats() or {}
    res = {"warm_median_s": sorted(walls)[len(walls) // 2],
           "warm_s": walls, "first_s": first, "compile_s": compile_s,
           "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
           "bytes": out.stat().st_size, "card": card}
    log(f"run {name}: warm median {res['warm_median_s']:.3f} s "
        f"(n={len(walls)}: {', '.join(f'{w:.3f}' for w in walls)}), first "
        f"{first:.3f} s, compile {compile_s:.3f} s, peak_bytes_in_use "
        f"{res['peak_bytes_in_use']} (process so far), file "
        f"{res['bytes']} B [{card}]")
    return res


# ---------------------------------------------------------------------------
# 5. correctness
# ---------------------------------------------------------------------------
def decode(path: pathlib.Path):
    import numpy as np
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None  # the full-resolution product is 400 MP
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def diff_stats(name: str, got, want, median_max: float,
               q99_max: float) -> dict:
    """|got - want| summary; `within` says whether it meets both limits."""
    import numpy as np

    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    signed = got.astype(np.int32) - want.astype(np.int32)
    diff = np.abs(signed)
    med = float(np.median(diff))
    q99 = float(np.percentile(diff, 99))
    res = {"median": med, "p99": q99, "max": int(diff.max()),
           "equal_share": float((diff == 0).mean()),
           "mean_signed": float(signed.mean()),
           "within": med <= median_max and q99 <= q99_max}
    log(f"check {name}: median |diff| {med}, p99 {q99}, max {res['max']}, "
        f"equal {res['equal_share']:.6f}, mean signed diff "
        f"{res['mean_signed']:.4f} (limits: median <= {median_max}, "
        f"p99 <= {q99_max})")
    return res


def compare(name: str, got, want, median_max: float, q99_max: float) -> dict:
    res = diff_stats(name, got, want, median_max, q99_max)
    if not res["within"]:
        raise AssertionError(f"{name}: outside its tolerance")
    return res


# Fast mode runs the percentile inversion in f32 and agrees with the exact
# host-f64 path to <= 1 histogram bin of window placement (README "Numerics
# contract"; tests/test_fused.py allows 2 u8 steps on 99% of synRGB
# pixels). Both sides then go through a q100 JPEG, which moves a decoded
# value by up to about 2 more on each side: median <= 1, p99 <= 6.
RGB_MEDIAN, RGB_P99 = 1.0, 6.0
# Exact mode on the card vs the CPU backend, in u16 codes (see correctness).
# Set between the two readings on an H100 (PERF.md): HIGHEST gives median 1,
# p99 2, nearly all of one sign (mean signed diff +0.65: the window moved);
# the TF32 control gives median 7, p99 24.
C_MEDIAN, C_P99 = 3.0, 7.0


def correctness(big: pathlib.Path, small: pathlib.Path) -> dict:
    import numpy as np

    from sarpro_tpu import api
    from sarpro_tpu.types import (AutoscaleStrategy, BitDepth, OutputFormat,
                                  Polarization)

    res = {}
    for name in ("a", "b"):
        args, _ = RUNS[name]
        exact = OUT / f"{name}_exact.jpg"
        cli(["-i", str(big), "-o", str(exact)]
            + [a for a in args if a != "--fast"])
        res[name] = compare(f"{name} fast vs exact", decode(OUT / f"{name}.jpg"),
                            decode(exact), RGB_MEDIAN, RGB_P99)

    # d: full resolution. The CLI's exact mode routes a scene this size to
    # the streamed fast path, so the exact reference is the in-memory exact
    # pipeline (api.process_safe_to_buffer, host-f64 windows).
    t0 = time.perf_counter()
    ref = api.process_safe_to_buffer(
        big, Polarization.MULTIBAND, AutoscaleStrategy.CLAHE, BitDepth.U8,
        None, False, OutputFormat.JPEG).rgb
    log(f"exact full-resolution reference in {time.perf_counter() - t0:.1f} s")
    res["d"] = compare("d fast (streamed) vs exact", decode(OUT / "d.jpg"),
                       np.asarray(ref), RGB_MEDIAN, RGB_P99)
    del ref

    # c: exact mode on the card vs the CPU backend, on the smaller scene
    # (4000 -> 1024 lanczos is 25 taps: the contraction route). GPU log/exp
    # differ from the CPU's in the last ulp and the resampler's sums run in
    # another order, which moves pixels and the window edges by a few u16
    # codes. The control runs the contraction in TF32, the fault HIGHEST
    # guards against: it must fall outside the limits, or the check could
    # not catch it.
    cpu = exact_c_cpu(small, OUT / "c_small_cpu.tiff")
    gpu = exact_c_gpu(small, OUT / "c_small_gpu.tiff")
    res["c"] = compare("c exact GPU vs exact CPU (4000^2 scene)", gpu, cpu,
                       C_MEDIAN, C_P99)
    import jax

    ctl = exact_c_gpu(small, OUT / "c_small_gpu_tf32.tiff",
                      jax.lax.DotAlgorithmPreset.TF32_TF32_F32)
    res["c_control"] = diff_stats(
        "control: c, contraction in TF32, vs exact CPU", ctl, cpu, C_MEDIAN,
        C_P99)
    if res["c_control"]["within"]:
        raise AssertionError("the GPU-vs-CPU limits do not catch a TF32 "
                             "contraction")
    return res


def exact_c_gpu(small: pathlib.Path, out: pathlib.Path, precision=None):
    """Run c on the small scene on the card; `precision` replaces the
    resampler contraction's HIGHEST for this run only."""
    import jax

    from sarpro_tpu.core import resize
    from sarpro_tpu.io.tiffio import TiffReader

    args, _ = RUNS["c"]
    saved = resize.CONTRACTION_PRECISION
    if precision is not None:
        resize.CONTRACTION_PRECISION = precision
        jax.clear_caches()
    try:
        cli(["-i", str(small), "-o", str(out)] + args)
    finally:
        if precision is not None:
            resize.CONTRACTION_PRECISION = saved
            jax.clear_caches()
    return TiffReader(out).read(1)


def exact_c_cpu(small: pathlib.Path, out: pathlib.Path):
    """Run c on the small scene in a CPU-only child process."""
    from sarpro_tpu.io.tiffio import TiffReader

    args, _ = RUNS["c"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    code = ("import sys; sys.path.insert(0, %r); from sarpro_tpu import cli; "
            "raise SystemExit(cli.run(%r))" % (
                str(REPO), ["-i", str(small), "-o", str(out)] + args))
    subprocess.run([sys.executable, "-c", code], env=env, check=True)
    return TiffReader(out).read(1)


# ---------------------------------------------------------------------------
# 6. kernels
# ---------------------------------------------------------------------------
def _median_ms(fn, *args, n: int = 10) -> float:
    import numpy as np

    fn(*args).block_until_ready()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args).block_until_ready()
        ts.append((time.perf_counter() - t0) * 1000.0)
    return float(np.median(ts))


def kernel_phase(big: pathlib.Path, card: str) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sarpro_tpu.core import clahe, resize
    from sarpro_tpu.io import warp as warp_mod
    from sarpro_tpu.ops import kernels as K

    key = jax.random.PRNGKey(SEED)
    # SAR-like skew: dB values are near-normal, so bin indices crowd into a
    # few hundred bins of the 4096
    db = jax.jit(lambda k: -15.0 + 4.0 * jax.random.normal(
        k, (SIDE, SIDE), jnp.float32))(key)

    def bins(nb):
        return jax.jit(lambda d: jnp.clip(((d + 40.0) / 50.0 * nb).astype(
            jnp.int32), 0, nb - 1))(db)

    res = {"histogram": {}}
    b256 = bins(256).ravel()
    cases = [
        ("256 bins, 800 M u8 (suppressed floor, both bands)", 256,
         jnp.concatenate([b256, b256[::-1]]).astype(jnp.uint8)),
        ("4096 bins, 400 M int32 (dB histogram)", 4096, bins(4096)),
        ("16384 bins, 400 M int32 (CLAHE 64 tiles x 256)", 16384,
         K._tile_index(b256, SIDE, clahe.TILES_X, clahe.TILES_Y,
                       SIDE // 8, SIDE // 8, 256)),
    ]
    for label, nb, x in cases:
        got = np.asarray(K.histogram(x, nb))
        want = np.bincount(np.asarray(x).ravel(), minlength=nb)[:nb]
        if not np.array_equal(got, want):
            raise AssertionError(f"histogram {label}: counts != numpy's")
        ms = _median_ms(functools.partial(K.histogram, num_bins=nb), x)
        res["histogram"][label] = {"xla_ms": ms, "total": int(got.sum())}
        log(f"histogram {label}: counts equal numpy's; XLA scatter "
            f"{ms:.3f} ms (median of 10) [{card}]")
    del cases

    # the lookups, the resampler and the warp sampler, at real sizes
    plain = {}
    cdfs = jnp.sort(jax.random.uniform(key, (64, 256)), axis=1)
    plain["clahe_lookup, 400 M px"] = _median_ms(jax.jit(
        lambda b, c: K.clahe_lookup(b, c, SIDE, 8, 8, SIDE // 8, SIDE // 8)),
        b256, cdfs)
    u8 = b256.astype(jnp.uint8)
    ramp = jnp.arange(256, dtype=jnp.uint8)
    luts = [ramp, ramp[::-1],
            jnp.arange(65536, dtype=jnp.int32).astype(jnp.uint8)]
    plain["synrgb_lookup, 400 M px"] = _median_ms(
        jax.jit(K.synrgb_lookup), u8, u8[::-1], *luts)
    del b256, u8
    dn = (jnp.exp(db / 10.0 * np.log(10.0)) * 1e4).astype(jnp.uint16)
    del db
    plain["resample rows 20000->2048 average (u16)"] = _median_ms(jax.jit(
        lambda x: resize._apply_axis0(x, "average", SIDE, 2048)), dn)
    plain["resample rows 20000->1024 lanczos (u16, einsum)"] = _median_ms(
        jax.jit(lambda x: resize._apply_axis0(x, "lanczos", SIDE, 1024)), dn)
    del dn
    src = jax.random.uniform(key, (2560, 2560), jnp.float32)
    g = np.linspace(0.0, 2559.0, 66)
    mx, my = np.meshgrid(g, g)
    plain["warp sample 2560^2 -> 2048^2 cubic"] = _median_ms(
        lambda s: warp_mod._warp_sample(
            s, jnp.asarray(mx * 0.98 + 20.0, jnp.float32),
            jnp.asarray(my * 0.97 + 10.0, jnp.float32), 2048, 2048, "cubic"),
        src)
    for k, v in plain.items():
        log(f"plain XLA {k}: {v:.3f} ms (median of 10) [{card}]")
    res["plain_xla_ms"] = plain
    del src

    # one traced warm run of d: device time by kernel name
    args, _ = RUNS["d"]
    argv = ["-i", str(big)] + args + ["-o", str(OUT / "d_trace.jpg")]
    trace_dir = WORK / "trace_d"
    shutil.rmtree(trace_dir, ignore_errors=True)
    cli(argv)
    with jax.profiler.trace(str(trace_dir)):
        cli(argv)
    res["trace_d_top"] = trace_top(trace_dir)
    return res


def trace_top(trace_dir: pathlib.Path, n: int = 15) -> list:
    """Device kernel time by event name over one traced window, largest
    first, with the device's busy time and the window's length."""
    from jax.profiler import ProfileData

    files = sorted(trace_dir.rglob("*.xplane.pb"))
    if not files:
        raise RuntimeError(f"no profiler trace under {trace_dir}")
    prof = ProfileData.from_file(str(files[-1]))
    per = {}
    spans = []
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                k = f"{line.name}: {ev.name}"
                per[k] = per.get(k, 0.0) + ev.duration_ns / 1e6
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        raise RuntimeError("the traced run of d put no operation on the GPU")
    spans.sort()
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (max(e for _, e in spans) - spans[0][0]) / 1e6
    top = sorted(per.items(), key=lambda kv: -kv[1])[:n]
    log(f"trace d: device busy {busy / 1e6:.1f} ms of a {window:.1f} ms "
        f"device window (first to last kernel)")
    for name, ms in top:
        log(f"  {ms:10.3f} ms  {name[:110]}")
    return [{"name": k, "ms": v} for k, v in top] + [
        {"device_busy_ms": busy / 1e6, "device_window_ms": window}]


def gpu_tests() -> None:
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(REPO / "tests" / "test_resize.py")])
    if rc != 0:
        raise RuntimeError(f"gpu-marked tests failed (pytest exit {rc})")
    log("gpu-marked tests passed")


# ---------------------------------------------------------------------------
# 7. four cards
# ---------------------------------------------------------------------------
def four_cards(big: pathlib.Path, card: str) -> dict:
    import numpy as np

    res = {}
    args, _ = RUNS["d"]
    one = OUT / "d_1card.jpg"
    four = OUT / "d_4card.jpg"
    t0 = time.perf_counter()
    cli(["-i", str(big), "-o", str(one)] + args)
    t1 = time.perf_counter()
    cli(["-i", str(big), "-o", str(four), "--shard-devices", "4"] + args)
    t2 = time.perf_counter()
    same = one.read_bytes() == four.read_bytes()
    res["shard_d"] = {"byte_identical": same, "one_card_s": t1 - t0,
                      "four_card_s": t2 - t1}
    log(f"run d --shard-devices 4 vs one card: byte-identical={same} "
        f"(first runs incl. compile: {t1 - t0:.1f} s / {t2 - t1:.1f} s) "
        f"[{card} x4]")
    if not same:
        raise AssertionError("row-sharded run d differs from the one-card file")

    # scene-batch mesh: 4 scenes (links to the same measurement rasters)
    src = WORK / "batch_in"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for i in range(4):
        scene = src / big.name.replace(".SAFE", f"{i}.SAFE")
        scene.mkdir()
        for part in ("manifest.safe", "annotation", "measurement"):
            (scene / part).symlink_to(big / part)
    outs = {}
    for label, extra in (("mesh", ["--device-batch", "4"]),
                         ("one_card", ["--device-batch", "1"])):
        out = OUT / f"batch_{label}"
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        with watch_scene_mesh() as calls:
            cli(["--input-dir", str(src), "--output-dir", str(out),
                 "--prefetch", "2"] + FAST_RGB + extra)
        files = sorted(out.glob("*.jpg"))
        if len(files) != 4:
            raise AssertionError(f"batch {label}: {len(files)} of 4 files")
        outs[label] = files
        log(f"batch {label}: 4 scenes in {time.perf_counter() - t0:.1f} s "
            f"(incl. compile); scene-mesh programs: {calls} [{card}]")
        # the mesh run must have sent all 4 scenes through ONE program over
        # 4 cards, and the one-card run none
        want = ([{"scenes": 4, "mesh_devices": 4, "result_devices": 4}]
                if label == "mesh" else [])
        if calls != want:
            raise AssertionError(f"batch {label}: scene-mesh programs "
                                 f"{calls}, expected {want}")
        res[f"batch_{label}_programs"] = calls
    worst = 0
    identical = 0
    for fm, f1 in zip(outs["mesh"], outs["one_card"]):
        if fm.read_bytes() == f1.read_bytes():
            identical += 1
            continue
        d = np.abs(decode(fm).astype(np.int32) - decode(f1).astype(np.int32))
        worst = max(worst, int(d.max()))
    res["batch"] = {"byte_identical_files": identical, "max_abs_diff": worst}
    log(f"batch mesh vs one card: {identical}/4 files byte-identical, max "
        f"decoded |diff| {worst}")
    # documented contract (--device-batch help): bucketed scenes may differ
    # from per-scene output by <= 1 u8 step, then a q100 JPEG on each side
    if worst > 1 + 2 * 2:
        raise AssertionError("scene-batch output outside its tolerance")
    return res


@contextlib.contextmanager
def watch_scene_mesh():
    """Yield a list that records each call of the scene-batch mesh program
    (parallel/sharded.synrgb_batch): scenes in, mesh size, and the number
    of devices its result lives on."""
    from sarpro_tpu.parallel import sharded

    calls = []
    real = sharded.synrgb_batch

    def watched(vv, vh, mesh, **kw):
        out = real(vv, vh, mesh, **kw)
        calls.append({"scenes": int(vv.shape[0]),
                      "mesh_devices": int(mesh.devices.size),
                      "result_devices": len(out.sharding.device_set)})
        return out

    sharded.synrgb_batch = watched
    try:
        yield calls
    finally:
        sharded.synrgb_batch = real


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, str(REPO))
    device = device_report(args.devices)
    card = device["card"]
    build()
    big = data(SIDE)
    OUT.mkdir(parents=True, exist_ok=True)
    summary = {"device": device}
    if args.devices == 4:
        summary["four_cards"] = four_cards(big, card)
    else:
        clock = CompileClock()
        runs = {}
        # d before c: the process's peak memory after d is d's own
        for name in ("a", "b", "d", "c"):
            flags, ext = RUNS[name]
            runs[name] = timed_run(name, ["-i", str(big)] + flags,
                                   OUT / f"{name}.{ext}", clock, card)
        summary["runs"] = runs
        summary["correctness"] = correctness(big, data(SMALL_SIDE))
        summary["kernels"] = kernel_phase(big, card)
        gpu_tests()
    (WORK / f"chip_smoke_{args.devices}.json").write_text(
        json.dumps(summary, indent=1))
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
