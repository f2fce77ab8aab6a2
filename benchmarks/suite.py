#!/usr/bin/env python3
"""Benchmark suite: the BASELINE.json configurations on one GPU.

bench.py stays the single-line headline metric; this suite prints the
device-program table for the reference's published configurations
(BASELINE.md) as JSON. All inputs are generated on the device, and each
timing ends in `block_until_ready`: they measure the device pipeline with
DN resident in device memory — the steady state of the pipelined batch
driver. It refuses to run on anything but a GPU.
"""
import functools
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

SIDE = 20000  # 400 MP per band, matching the reference's headline product


def main():
    import jax
    import jax.numpy as jnp

    from sarpro_tpu.core import fused, ops
    from sarpro_tpu.types import AutoscaleStrategy, BitDepth

    from sarpro_tpu.utils.compilation_cache import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"suite.py measures the GPU; JAX found "
                         f"{dev.platform!r}")
    print(f"device: {dev.device_kind} x{len(jax.devices())}")

    @functools.partial(jax.jit, static_argnames=("side",))
    def _gen_sized(k, mean, side):
        x = jnp.exp(mean + 1.1 * jax.random.normal(k, (side, side)))
        zeros = jax.random.bernoulli(jax.random.fold_in(k, 1), 0.01,
                                     (side, side))
        return jnp.where(zeros, 0, jnp.clip(x, 0, 65535)).astype(jnp.uint16)

    def gen_sized(k, mean, side):
        return _gen_sized(k, mean, side=side)

    k1, k2 = jax.random.split(jax.random.PRNGKey(42))
    vv = gen_sized(k1, 5.0, SIDE)
    vh = gen_sized(k2, 4.2, SIDE)
    vh.block_until_ready()

    def force(x):
        return jax.block_until_ready(x)

    def timeit(name, fn, iters=7):
        t0 = time.perf_counter()
        force(fn())
        compile_s = time.perf_counter() - t0
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            force(fn())
            ts.append((time.perf_counter() - t0) * 1000.0)
        p50 = float(np.percentile(ts, 50))
        print(f"{name:58s} {p50:9.2f} ms  (compile {compile_s:.0f}s)",
              flush=True)
        return {"name": name, "p50_ms": round(p50, 2),
                "times_ms": [round(t, 2) for t in ts],
                "compile_s": round(compile_s, 1)}

    results = []

    # 1. VV → 512 u8 grayscale, standard autoscale (BASELINE config #1)
    results.append(timeit(
        "cfg1: VV 400MP -> 512 u8 gray, standard",
        functools.partial(fused.grayscale_pipeline, vv,
                          strategy=AutoscaleStrategy.STANDARD,
                          bit_depth=BitDepth.U8, target_size=512),
    ))

    # 2. VV → 1024 u16, robust + lanczos downsample-on-read (config #2)
    results.append(timeit(
        "cfg2: VV 400MP -> 1024 u16, robust, lanczos",
        functools.partial(fused.grayscale_pipeline, vv,
                          strategy=AutoscaleStrategy.ROBUST,
                          bit_depth=BitDepth.U16, target_size=1024,
                          resample_alg="lanczos"),
    ))

    # 3. ratio + log-ratio gray products, adaptive, 1024 (config #3)
    def cfg3():
        r = ops.ratio_arrays(vv, vh)
        g1 = fused.grayscale_pipeline(r, strategy=AutoscaleStrategy.ADAPTIVE,
                                      bit_depth=BitDepth.U8, target_size=1024)
        lr = ops.log_ratio_arrays(vv, vh)
        g2 = fused.grayscale_pipeline(lr, strategy=AutoscaleStrategy.ADAPTIVE,
                                      bit_depth=BitDepth.U8, target_size=1024)
        return g1[0, 0].astype(jnp.int32) + g2[0, 0].astype(jnp.int32)

    results.append(timeit("cfg3: ratio + log-ratio 400MP -> 1024, adaptive", cfg3))

    # 4. dual-pol → 2048 synRGB CLAHE + pad (config #4, the headline)
    results.append(timeit(
        "cfg4: VV+VH 400MP -> 2048 synRGB, CLAHE, pad",
        functools.partial(fused.synrgb_pipeline, vv, vh,
                          strategy=AutoscaleStrategy.CLAHE,
                          target_size=2048, pad=True),
    ))

    # 4b. the PRODUCTION file-path program: same as cfg4 but ending in the
    #     in-graph JPEG front-end (YCbCr + 8x8 FDCT + q100 quantize) —
    #     the host then pays entropy coding only
    results.append(timeit(
        "cfg4b: cfg4 + in-graph JPEG front-end (dct layout)",
        functools.partial(fused.synrgb_pipeline, vv, vh,
                          strategy=AutoscaleStrategy.CLAHE,
                          target_size=2048, pad=True, channel_order="dct"),
    ))

    # 5. multiband u16 warped (config #5's per-scene compute): the warp's
    #    device half, the gather sampler. Mimics a -ts warp to ~2000px with
    #    mild rotation.
    from sarpro_tpu.io import warp as warp_mod

    WOUT = 2048
    gh = gw = 129
    yyn, xxn = np.meshgrid(np.linspace(0, 1, gh), np.linspace(0, 1, gw),
                           indexing="ij")
    # pre-downsampled intermediate (the two-stage warp path) at 1.25x output
    mid = int(WOUT * 1.25)
    vv_mid = fused._resample_dn(vv, mid, mid, "average")
    _ = force(vv_mid)
    map_x = (xxn * 0.95 + 0.02 * yyn) * (mid - 8) + 3.0
    map_y = (yyn * 0.94 + 0.015 * xxn) * (mid - 8) + 2.0

    def cfg5():
        w1 = warp_mod._warp_sample(
            vv_mid, jnp.asarray(map_x, jnp.float32),
            jnp.asarray(map_y, jnp.float32), WOUT, WOUT, "cubic")
        g = fused.grayscale_pipeline(w1, strategy=AutoscaleStrategy.STANDARD,
                                     bit_depth=BitDepth.U16, target_size=1024)
        return g

    results.append(timeit(
        "cfg5: two-stage warp(cubic) 400MP -> 2048 + u16 1024", cfg5))

    # 6. full-resolution dual-band synRGB at 144 MP/band (reference native-
    #    res path: ~40 s CPU at 704 MP total; this is its single-program
    #    regime)
    side6 = 8486
    vv6 = vv[:side6, :side6]
    vh6 = vh[:side6, :side6]
    _ = force(vv6)
    results.append(timeit(
        "cfg6: full-res 72MP/band (144MP dual) synRGB, CLAHE (single program)",
        functools.partial(fused.synrgb_pipeline, vv6, vh6,
                          strategy=AutoscaleStrategy.CLAHE,
                          target_size=None, pad=False),
        iters=5,
    ))

    # 7. streamed big-scene path at 704 MP/band (26544², the reference's
    #    Mt. Fuji full-res scene: ~50 s CPU). Generated at full size on
    #    device; chunked multi-pass (core/streamed.py).
    from sarpro_tpu.core import streamed as streamed_mod

    side7 = 26544
    vv7 = gen_sized(jax.random.PRNGKey(7), 5.0, side7)
    vh7 = gen_sized(jax.random.PRNGKey(8), 4.2, side7)
    _ = force(vv7)

    def cfg7():
        return streamed_mod.synrgb_streamed(
            vv7, vh7, strategy=AutoscaleStrategy.CLAHE)

    results.append(timeit(
        "cfg7: streamed full-res 704MP/band dual synRGB, CLAHE", cfg7,
        iters=3,
    ))

    out = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "input": f"{SIDE}x{SIDE} u16 dual-pol (400 MP/band), "
                 f"device-resident",
        "reference_baselines_ms": {
            "cfg4_no_warp": 348.21, "cfg4_with_warp": 1500.0,
            "full_res_native": 40000.0,
        },
        "results": results,
    }
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
