"""Core processing: the dense per-pixel compute chain, on device.

Layering (mirrors the reference's src/core/processing/ but re-architected for
XLA): device-side array programs live in `pipeline`, `clahe`, `resize`,
`synthetic_rgb`, `ops`; tiny data-dependent scalar logic (percentile
inversion, strategy window selection) lives host-side in `stats` in float64,
reproducing the reference's f64 semantics exactly.
"""
