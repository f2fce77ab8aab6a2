"""Float64 NumPy oracle of the reference's CPU semantics.

Every function here is an independent, loop-level re-statement of the Rust
behavior (with its exact truncating casts and half-away-from-zero rounds),
used as golden truth for the device kernels. Cites are into the reference's
source tree (bogwi/sarpro).
Keep these slow-and-obvious; they only run on small test images.
"""
from __future__ import annotations

import numpy as np

NUM_BINS = 4096


def rust_round(x):
    """Rust f64/f32 .round(): half away from zero."""
    return np.trunc(x + np.copysign(0.5, x))


def db_and_mask(x_f32: np.ndarray):
    """reference: pipeline.rs:8-40 (f64 dB + validity mask)."""
    mag = np.maximum(x_f32.astype(np.float64), 1e-10)
    db = 10.0 * np.log10(mag)
    return db, db > -50.0


def histogram_stats(db: np.ndarray, valid: np.ndarray) -> dict:
    """reference: autoscale.rs:35-160."""
    v = db.ravel()[valid.ravel()]
    count = v.size
    names = ["median_db", "p01", "p02", "p05", "p10", "p25", "p75", "p90", "p95", "p98", "p99"]
    if count == 0:
        return {k: 0.0 for k in
                ["min_db", "max_db", "mean_db", "std_db"] + names} | {"valid_count": 0}
    mn, mx = float(v.min()), float(v.max())
    mean = float(v.mean())
    std = float(np.sqrt(np.sum((v - mean) ** 2) / count)) if count > 1 else 0.0
    out = {"valid_count": count, "min_db": mn, "max_db": mx, "mean_db": mean, "std_db": std}
    if abs(mx - mn) < np.finfo(np.float64).eps:
        lowish = {"median_db": mn, "p01": mn, "p02": mn, "p05": mn, "p10": mn, "p25": mn}
        highish = {"p75": mx, "p90": mx, "p95": mx, "p98": mx, "p99": mx}
        return out | lowish | highish
    span = mx - mn
    t = np.clip((v - mn) / span, 0.0, 1.0)
    idx = np.minimum((t * NUM_BINS).astype(np.int64), NUM_BINS - 1)
    hist = np.bincount(idx, minlength=NUM_BINS)

    def pct(p):
        target = min(int(np.floor(p * count)), count - 1)
        cum = 0
        for b in range(NUM_BINS):
            h = int(hist[b])
            if target < cum + h:
                within = max(target - cum, 0)
                frac = within / h if h > 0 else 0.0
                bw = span / NUM_BINS
                return mn + b * bw + frac * bw
            cum += h
        return mx

    pcts = {"median_db": 0.5, "p01": 0.01, "p02": 0.02, "p05": 0.05, "p10": 0.10,
            "p25": 0.25, "p75": 0.75, "p90": 0.90, "p95": 0.95, "p98": 0.98, "p99": 0.99}
    return out | {k: pct(p) for k, p in pcts.items()}


def _quantize(db, valid, low, high, gamma, max_val):
    """reference: autoscale.rs:437-447 / :644-656."""
    rng = max(high - low, 1.0)
    clipped = np.clip(db, low, high)
    norm = ((clipped - low) / rng) ** gamma
    q = np.clip(np.trunc(np.clip(norm * max_val, 0.0, max_val)), 0, 65535).astype(np.uint16)
    return np.where(valid, q, np.uint16(0))


def autoscale_db_image(db, valid, bit_depth_max):
    """Standard autoscale (reference: autoscale.rs:368-448)."""
    s = histogram_stats(db, valid)
    if s["valid_count"] == 0:
        return np.zeros(db.shape, np.uint16)
    dr = s["max_db"] - s["min_db"]
    iqr = s["p75"] - s["p25"]
    if dr < 15.0:
        rng = max(20.0, dr * 0.8)
        low, high, gamma = s["median_db"] - rng / 2, s["median_db"] + rng / 2, 1.1
    elif iqr < 5.0:
        low, high, gamma = s["p25"] - 2.5 * iqr, s["p75"] + 2.5 * iqr, 1.0
    elif dr > 40.0:
        low = max(s["p02"], s["min_db"] + 0.02 * dr)
        high = min(s["p98"], s["max_db"] - 0.02 * dr)
        gamma = 0.9
    else:
        low, high, gamma = s["p02"], s["p98"], 1.0
    low = max(low, s["min_db"])
    high = min(high, s["max_db"])
    return _quantize(db, valid, low, high, gamma, bit_depth_max)


def advanced_window(s: dict, strategy: str):
    """reference: autoscale.rs:491-562."""
    iqr = s["p75"] - s["p25"]
    if strategy == "robust":
        thr = 2.5 * iqr
        return (max(s["p25"] - thr, s["p01"], s["min_db"]),
                min(s["p75"] + thr, s["p99"], s["max_db"]), 1.0)
    if strategy == "adaptive":
        skew = (s["mean_db"] - s["median_db"]) / max(abs(s["std_db"]), 1.0)
        tail = (s["p99"] - s["p95"]) / max(s["p95"] - s["p75"], 1.0)
        if abs(skew) > 0.5:
            lp, hp, g = (0.02, 0.98, 0.9) if skew > 0 else (0.05, 0.95, 1.1)
        elif tail > 2.0:
            lp, hp, g = 0.10, 0.90, 0.8
        else:
            lp, hp, g = 0.05, 0.95, 1.0
        low = {0.10: s["p10"], 0.02: s["p02"], 0.05: s["p05"], 0.25: s["p25"]}.get(lp, s["p05"])
        high = {0.90: s["p90"], 0.98: s["p98"], 0.95: s["p95"], 0.99: s["p99"]}.get(hp, s["p95"])
        return low, high, g
    if strategy in ("equalized", "clahe"):
        return s["p01"], s["p99"], 1.0
    if strategy == "tamed":
        return s["p25"], s["p99"], 1.0
    return s["p05"], s["p95"], 1.0  # standard/default


def clahe_equalize_normalized(norm, valid, tiles_x=8, tiles_y=8,
                              clip_limit=2.0, num_bins=256):
    """Direct per-pixel CLAHE (reference: autoscale.rs:220-345)."""
    rows, cols = norm.shape
    if rows == 0 or cols == 0:
        return norm.copy()
    tile_h = -(-rows // tiles_y)
    tile_w = -(-cols // tiles_x)
    cdfs = np.zeros((tiles_y * tiles_x, num_bins))
    for ty in range(tiles_y):
        r0, r1 = ty * tile_h, min((ty + 1) * tile_h, rows)
        for tx in range(tiles_x):
            c0, c1 = tx * tile_w, min((tx + 1) * tile_w, cols)
            hist = np.zeros(num_bins, np.float64)
            for r in range(r0, r1):
                for c in range(c0, c1):
                    if valid[r, c]:
                        v = min(max(norm[r, c], 0.0), 1.0)
                        b = int(rust_round(v * (num_bins - 1.0)))
                        b = min(max(b, 0), num_bins - 1)
                        hist[b] += 1
            avg = ((r1 - r0) * (c1 - c0)) / num_bins
            thr = max(clip_limit * avg, 1.0)
            excess = 0.0
            for b in range(num_bins):
                if hist[b] > thr:
                    excess += hist[b] - thr
                    hist[b] = np.trunc(thr)
            add = np.floor(excess / num_bins)
            rem = int(rust_round(excess - add * num_bins))
            hist = np.trunc(hist + add)
            b = 0
            while rem > 0:
                hist[b] += 1
                b = (b + 1) % num_bins
                rem -= 1
            total = max(hist.sum(), 1.0)
            cdfs[ty * tiles_x + tx] = np.clip(np.cumsum(hist) / total, 0.0, 1.0)

    out = np.zeros((rows, cols))
    for r in range(rows):
        for c in range(cols):
            if not valid[r, c]:
                continue
            rf = r / tile_h - 0.5
            cf = c / tile_w - 0.5
            ty = int(max(np.floor(rf), 0.0))
            tx = int(max(np.floor(cf), 0.0))
            dy = rf - ty
            dx = cf - tx
            ty0 = min(max(ty, 0), tiles_y - 1)
            tx0 = min(max(tx, 0), tiles_x - 1)
            ty1 = min(max(ty + 1, 0), tiles_y - 1)
            tx1 = min(max(tx + 1, 0), tiles_x - 1)
            bp = int(rust_round(min(max(norm[r, c], 0.0), 1.0) * (num_bins - 1.0)))
            bp = min(max(bp, 0), num_bins - 1)
            c00 = cdfs[ty0 * tiles_x + tx0][bp]
            c01 = cdfs[ty0 * tiles_x + tx1][bp]
            c10 = cdfs[ty1 * tiles_x + tx0][bp]
            c11 = cdfs[ty1 * tiles_x + tx1][bp]
            top = c00 * (1 - dx) + c01 * dx
            bot = c10 * (1 - dx) + c11 * dx
            out[r, c] = top * (1 - dy) + bot * dy
    return out


def autoscale_db_image_advanced(db, valid, bit_depth_max, strategy):
    """reference: autoscale.rs:452-659."""
    s = histogram_stats(db, valid)
    if s["valid_count"] == 0:
        return np.zeros(db.shape, np.uint16)
    low, high, gamma = advanced_window(s, strategy)
    if strategy == "clahe":
        rng = max(high - low, 1.0)
        norm = np.where(valid, (np.clip(db, low, high) - low) / rng, 0.0)
        eq = clahe_equalize_normalized(norm, valid)
        q = np.trunc(np.clip(eq, 0.0, 1.0) * bit_depth_max).astype(np.uint16)
        return np.where(valid, q, np.uint16(0))
    return _quantize(db, valid, low, high, gamma, bit_depth_max)


def scale_u16_to_u8(data: np.ndarray) -> np.ndarray:
    """reference: autoscale.rs:348-364 (f32 arithmetic)."""
    if data.size == 0:
        return data.astype(np.uint8)
    mn = np.float32(data.min())
    mx = np.float32(data.max())
    scale = np.float32(255.0) / (mx - mn) if mx > mn else np.float32(1.0)
    val = rust_round((data.astype(np.float32) - mn) * scale)
    return np.clip(val, 0, 255).astype(np.uint8)


def tamed_synrgb_u8(db, valid, is_copol):
    """reference: autoscale.rs:710-742."""
    s = histogram_stats(db, valid)
    if s["valid_count"] == 0:
        return np.zeros(db.shape, np.uint8)
    low = min(s["p02"], s["p05"]) if is_copol else s["p05"]
    high = s["p99"]
    rng = max(high - low, 1.0)
    clipped = np.clip(db, low, high)
    q = np.clip(np.trunc(np.clip((clipped - low) / rng * 255.0, 0, 255)), 0, 255).astype(np.uint8)
    return np.where(valid, q, np.uint8(0))


def synthetic_rgb_default(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    """reference: synthetic_rgb.rs:10-67 (f32 LUT math, per pixel)."""
    f = np.float32
    lut_r = np.zeros(256, np.uint8)
    lut_g = np.zeros(256, np.uint8)
    for v in range(256):
        vf = f(v) / f(255)
        lut_r[v] = min(max(rust_round(vf ** f(0.7) * f(255)), 0), 255)
        lut_g[v] = min(max(rust_round(vf ** f(0.9) * f(255)), 0), 255)
    lut_b = np.zeros((256, 256), np.uint8)
    for a in range(256):
        for b in range(256):
            if b == 0:
                continue
            r = f(lut_r[a])
            g = f(lut_g[b])
            ratio = np.divide(r, g) if g != 0 else np.float32(np.inf)
            val = min(max(ratio ** f(0.1) * f(255) * f(0.24), f(0)), f(255))
            lut_b[a, b] = rust_round(val)
    out = np.zeros(b1.shape + (3,), np.uint8)
    out[..., 0] = lut_r[b1]
    out[..., 1] = lut_g[b2]
    out[..., 2] = lut_b[b1, b2]
    return out


def synthetic_rgb_suppressed(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    """reference: synthetic_rgb.rs:88-178."""
    f = np.float32
    hist = np.bincount(b1.ravel(), minlength=256) + np.bincount(b2.ravel(), minlength=256)
    total = b1.size + b2.size
    target = int(rust_round(total * 0.05))
    cum = 0
    floor_value = 0
    for i in range(256):
        cum += int(hist[i])
        if cum >= target:
            floor_value = i
            break
    floor_c = min(floor_value + 3, 40)
    floor = f(floor_c)
    denom = max(f(255) - floor, f(1))
    lut_r = np.zeros(256, np.uint8)
    lut_g = np.zeros(256, np.uint8)
    for v in range(256):
        if v <= floor_c:
            continue
        shifted = (f(v) - floor) / denom
        lut_r[v] = min(max(rust_round(shifted ** f(1.15) * f(255)), 0), 255)
        lut_g[v] = min(max(rust_round(shifted ** f(1.10) * f(255)), 0), 255)
    lut_b = np.zeros((256, 256), np.uint8)
    for a in range(256):
        for b in range(256):
            r = f(lut_r[a])
            g = f(lut_g[b])
            ratio = (r + f(8)) / (g + f(8))
            val = min(max(ratio ** f(0.1) * f(255) * f(0.18), f(0)), f(255))
            lut_b[a, b] = rust_round(val)
    out = np.zeros(b1.shape + (3,), np.uint8)
    water = (b1 <= floor_c) & (b2 <= floor_c)
    out[..., 0] = np.where(water, 0, lut_r[b1])
    out[..., 1] = np.where(water, 0, lut_g[b2])
    out[..., 2] = np.where(water, 0, lut_b[b1, b2])
    return out


def pol_ops(a: np.ndarray, b: np.ndarray, op: str) -> np.ndarray:
    """reference: ops.rs:4-44."""
    a = a.astype(np.float32)
    b = b.astype(np.float32)
    if op == "sum":
        return a + b
    if op == "diff":
        return a - b
    if op in ("ratio", "log-ratio"):
        return np.where(np.abs(b) > 1e-10, np.divide(a, np.where(b == 0, 1, b)), 0.0).astype(np.float32)
    if op == "n-diff":
        d = a + b
        return np.where(np.abs(d) > 1e-10, (a - b) / np.where(d == 0, 1, d), 0.0).astype(np.float32)
    raise ValueError(op)


def pad_to_square(arr2d: np.ndarray) -> np.ndarray:
    """reference: padding.rs:5-49."""
    rows, cols = arr2d.shape
    m = max(rows, cols)
    out = np.zeros((m, m), arr2d.dtype)
    pr = (m - rows) // 2
    pc = (m - cols) // 2
    out[pr:pr + rows, pc:pc + cols] = arr2d
    return out


def jpeg_dct_oracle(planes_u8: np.ndarray) -> np.ndarray:
    """f64 oracle of the JPEG front-end (native/jpegenc.cpp fdct8x8 and
    fused.jpeg_dct_planes): level shift + orthonormal FDCT + q100 rint,
    emitted in the native encoder's TRANSPOSED block layout.

    `planes_u8` is (c, h, w) with h, w multiples of 8; returns
    (c, h//8, w//8, 8, 8) int16."""
    u = np.arange(8, dtype=np.float64)
    s = np.where(u == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    T = s[:, None] * np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16)
    c, h, w = planes_u8.shape
    x = planes_u8.astype(np.float64) - 128.0
    b = x.reshape(c, h // 8, 8, w // 8, 8).transpose(0, 1, 3, 2, 4)
    out = np.einsum("ik,cyxkl,jl->cyxji", T, b, T)  # (T·B·Tᵀ)ᵀ
    return np.rint(out).astype(np.int16)


def decode_baseline_jpeg_coeffs(blob: bytes, n_mcus: int):
    """Minimal baseline-JPEG entropy DECODER (test oracle): parses DHT/SOS
    from the stream itself and Huffman-decodes `n_mcus` MCUs back to
    per-block zigzag-ordered int arrays (DC differentially reconstructed,
    AC as stored). Single- or multi-component interleaved scans, restart
    markers, and 0xFF00 stuffing are handled. This checks the ENTROPY
    layer bit-exactly — unlike a pixel decode, whose IDCT clamps/wraps on
    synthetic out-of-range coefficient patterns.

    Returns (blocks, ncomp): blocks[i] is the i-th block of the scan in
    MCU order (component-interleaved), a list of 64 ints in zigzag order.
    """
    tables = {}  # (class, id) -> prefix dict {(len, code): value}
    pos = 2  # past SOI
    ncomp = None
    comp_tabs = []  # per scan component: (dc_table, ac_table)
    ri = 0
    while pos < len(blob):
        assert blob[pos] == 0xFF, hex(blob[pos])
        marker = blob[pos + 1]
        if marker == 0xD9:  # EOI
            raise AssertionError("EOI before SOS")
        seg_len = (blob[pos + 2] << 8) | blob[pos + 3]
        body = blob[pos + 4:pos + 2 + seg_len]
        pos += 2 + seg_len
        if marker == 0xC4:  # DHT (possibly several tables per segment)
            b = 0
            while b < len(body):
                tc_th = body[b]
                bits = body[b + 1:b + 17]
                nv = sum(bits)
                vals = body[b + 17:b + 17 + nv]
                b += 17 + nv
                code, k, tab = 0, 0, {}
                for ln in range(1, 17):
                    for _ in range(bits[ln - 1]):
                        tab[(ln, code)] = vals[k]
                        code += 1
                        k += 1
                    code <<= 1
                tables[(tc_th >> 4, tc_th & 15)] = tab
        elif marker == 0xDD:  # DRI
            ri = (body[0] << 8) | body[1]
        elif marker == 0xDA:  # SOS
            ns = body[0]
            ncomp = ns
            for ci in range(ns):
                td_ta = body[2 + 2 * ci]
                comp_tabs.append((tables[(0, td_ta >> 4)],
                                  tables[(1, td_ta & 15)]))
            break
    assert ncomp is not None, "no SOS found"

    # entropy-coded data: strip stuffing, split on RST markers
    data = blob[pos:]
    segments, cur = [], bytearray()
    i = 0
    while i < len(data):
        b = data[i]
        if b == 0xFF:
            nxt = data[i + 1]
            if nxt == 0x00:
                cur.append(0xFF)
                i += 2
                continue
            if 0xD0 <= nxt <= 0xD7:  # RSTm: new segment, DC predictors reset
                segments.append(bytes(cur))
                cur = bytearray()
                i += 2
                continue
            if nxt == 0xD9:
                segments.append(bytes(cur))
                break
            raise AssertionError(f"unexpected marker FF{nxt:02X} in scan")
        cur.append(b)
        i += 1

    def extend(v, s):
        return v if v >= (1 << (s - 1)) else v - (1 << s) + 1

    blocks = []
    mcus_done = 0
    for seg in segments:
        bitpos = 0

        def read_bit():
            nonlocal bitpos
            byte = seg[bitpos >> 3]
            bit = (byte >> (7 - (bitpos & 7))) & 1
            bitpos += 1
            return bit

        def read_bits(n):
            v = 0
            for _ in range(n):
                v = (v << 1) | read_bit()
            return v

        def read_symbol(tab):
            ln, code = 0, 0
            while True:
                code = (code << 1) | read_bit()
                ln += 1
                if (ln, code) in tab:
                    return tab[(ln, code)]
                assert ln <= 16, "invalid Huffman code"

        dc_pred = [0] * ncomp  # predictors reset at each restart segment
        seg_mcus = 0  # a restart interval holds exactly `ri` MCUs (the
        # last may hold fewer); the remainder of the segment is byte pad
        while (mcus_done < n_mcus and bitpos < len(seg) * 8
               and (ri == 0 or seg_mcus < ri)):
            for ci in range(ncomp):
                dct, act = comp_tabs[ci]
                blk = [0] * 64
                s = read_symbol(dct)
                diff = extend(read_bits(s), s) if s else 0
                dc_pred[ci] += diff
                blk[0] = dc_pred[ci]
                k = 1
                while k < 64:
                    sym = read_symbol(act)
                    if sym == 0x00:  # EOB
                        break
                    run, size = sym >> 4, sym & 15
                    if sym == 0xF0:  # ZRL
                        k += 16
                        continue
                    k += run
                    blk[k] = extend(read_bits(size), size)
                    k += 1
                blocks.append(blk)
            mcus_done += 1
            seg_mcus += 1
    assert mcus_done == n_mcus, (mcus_done, n_mcus)
    return blocks, ncomp
