"""Headline benchmark: 400 MP dual-pol GRD → 2048×2048 synthetic RGB.

PRIMARY metric: the reference's own headline configuration — the scene
with auto-UTM reprojection + padding → tamed synRGB JPEG, ~1.5 s on a
12-core Apple M4 Pro (BASELINE.md row 1). The no-warp arm
(`--target-crs none`, the reference's 348.21 ms row) is measured the same
way and reported under `extra`, beside the device-resident program time.

Every number is a measured wall on the GPU: end to end from the SAFE on
local disk to the written JPEG through the `--fast` file API (median of
the timed runs after a warm-up), and the fused program on device-resident
input ending in `block_until_ready`. The script refuses to run without a
GPU and names the card (device kind, count, name and power limit).

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", "extra"}.
"""
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
BASELINE_NO_WARP_MS = 348.21  # BASELINE.md, --target-crs none
BASELINE_WITH_WARP_MS = 1500.0  # BASELINE.md, reprojection + padding


def card() -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found "
                         f"{devs[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi.splitlines()[0]}


def device_resident_ms(side: int = 20000, runs: int = 10) -> tuple:
    """Fused 2048 CLAHE synRGB program on DN already on the device."""
    import jax
    import jax.numpy as jnp

    from sarpro_tpu.core import fused
    from sarpro_tpu.types import AutoscaleStrategy

    k1, k2 = jax.random.split(jax.random.PRNGKey(42))

    @jax.jit
    def gen(k, mean):
        x = jnp.exp(mean + 1.1 * jax.random.normal(k, (side, side)))
        zeros = jax.random.bernoulli(jax.random.fold_in(k, 1), 0.01,
                                     (side, side))
        return jnp.where(zeros, 0, jnp.clip(x, 0, 65535)).astype(jnp.uint16)

    vv, vh = gen(k1, 5.0), gen(k2, 4.2)
    fn = functools.partial(fused.synrgb_pipeline,
                           strategy=AutoscaleStrategy.CLAHE,
                           target_size=2048, pad=True)
    fn(vv, vh).block_until_ready()  # compile
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn(vv, vh).block_until_ready()
        ts.append((time.perf_counter() - t0) * 1000.0)
    return float(np.median(ts)), ts


def main():
    dev = card()
    subprocess.run([sys.executable, str(REPO / "native" / "build.py")],
                   check=True, capture_output=True)
    from benchmarks import e2e

    resident_p50, resident = device_resident_ms()
    no_warp = e2e.run_e2e(runs=5)
    with_warp = e2e.run_e2e_warp(runs=5)
    print(json.dumps({
        "metric": "400MP dual-pol SAFE disk->auto-UTM warp+pad->2048 tamed "
                  "synRGB JPEG, e2e wall p50 (--fast)",
        "value": round(with_warp["p50_ms"], 1),
        "unit": "ms",
        "vs_baseline": round(BASELINE_WITH_WARP_MS / with_warp["p50_ms"], 2),
        "extra": {
            "with_warp": with_warp,
            "no_warp": no_warp,
            "vs_baseline_no_warp": round(
                BASELINE_NO_WARP_MS / no_warp["p50_ms"], 2),
            "device_resident_2048_clahe_p50_ms": round(resident_p50, 3),
            "device_resident_times_ms": [round(t, 3) for t in resident],
            "device": dev,
        },
    }))


if __name__ == "__main__":
    main()
