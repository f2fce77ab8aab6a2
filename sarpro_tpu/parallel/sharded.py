"""Sharded pipelines: scene-batched, row-sharded processing over a Mesh.

Design (SURVEY.md §2.5, the accelerator equivalents):
  * a batch of same-shaped scenes is laid out (scene, rows, cols) and sharded
    P('scene', 'row', None): scenes spread across the 'scene' axis, each
    scene's rows split across the 'row' axis;
  * the primary path is `jax.shard_map`: each device runs the fused pipeline
    (core/fused.py) on its LOCAL row block with `row_axis='row'` — the
    histogram/CLAHE/min-max reductions become explicit `psum`/`pmin`/`pmax`
    collectives;
  * CLAHE's tile CDFs are computed from the psum-combined global tile
    histograms; the bilinear apply runs locally with each shard's global row
    offset, so no halo exchange is needed at all;
  * whole-raster transforms (in-graph resampling to a target size, square
    padding) do not row-shard; those configs take the GSPMD path, which
    partitions the histogram scatters itself. Multi-device processing
    targets full-res scenes — the downsampled ones fit a single device.

Scenes of different shapes are bucketed by the host driver (batch.py) before
entering here — XLA requires static shapes, so one compiled program serves
each bucket.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import fused
from ..types import AutoscaleStrategy, BitDepth

SCENE_SPEC = P("scene", "row", None)
RGB_OUT_SPEC = P("scene", "row", None, None)

def shard_scene_batch(batch, mesh: Mesh):
    """Place a (scenes, rows, cols) array with scene+row sharding."""
    return jax.device_put(batch, NamedSharding(mesh, SCENE_SPEC))


# ---------------------------------------------------------------------------
# Primary path: shard_map with explicit collectives
# ---------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("strategy", "mesh"))
def _synrgb_shardmap_jit(vv, vh, strategy, mesh):
    row_shards = mesh.shape["row"]

    def per_device(vv_l, vh_l):  # (scenes_local, rows_local, cols)
        def one(a, b):
            return fused.synrgb_pipeline(
                a, b, strategy=strategy, target_size=None, pad=False,
                row_axis="row", row_shards=row_shards,
            )

        return jnp.stack([one(vv_l[i], vh_l[i])
                          for i in range(vv_l.shape[0])])

    return jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(SCENE_SPEC, SCENE_SPEC), out_specs=RGB_OUT_SPEC,
        check_vma=False,
    )(vv, vh)


@functools.partial(jax.jit, static_argnames=("strategy", "bit_depth", "mesh"))
def _gray_shardmap_jit(dn, strategy, bit_depth, mesh):
    row_shards = mesh.shape["row"]

    def per_device(dn_l):
        def one(a):
            return fused.grayscale_pipeline(
                a, strategy=strategy, bit_depth=bit_depth, target_size=None,
                pad=False, row_axis="row", row_shards=row_shards,
            )

        return jnp.stack([one(dn_l[i]) for i in range(dn_l.shape[0])])

    return jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(SCENE_SPEC,), out_specs=SCENE_SPEC,
        check_vma=False,
    )(dn)


# ---------------------------------------------------------------------------
# GSPMD path (resample/pad configs): auto-partitioned
# ---------------------------------------------------------------------------
@functools.partial(
    jax.jit,
    static_argnames=("strategy", "target_size", "pad", "mesh",
                     "channel_order"),
)
def _synrgb_batch_jit(vv, vh, strategy, target_size, pad, mesh,
                      channel_order="rgb"):
    fn = functools.partial(
        fused.synrgb_pipeline,
        strategy=strategy, target_size=target_size, pad=pad,
        channel_order=channel_order,
    )
    out = jax.vmap(fn)(vv, vh)
    # ycbcr emits PLANAR (scene, 3, rows, cols): rows move to axis 2 and the
    # 3-length channel axis must stay replicated, or the 'row' mesh axis
    # would try to split it
    if channel_order == "ycbcr":
        spec = P("scene", None, "row", None)
    elif channel_order == "dct":
        # quantized DCT blocks (scene, 3, bh, bw, 8, 8): shard scenes only —
        # bh = rows/8 need not divide the 'row' axis
        spec = P("scene")
    else:
        spec = RGB_OUT_SPEC
    return jax.lax.with_sharding_constraint(out, NamedSharding(mesh, spec))


@functools.partial(
    jax.jit,
    static_argnames=("strategy", "bit_depth", "target_size", "pad", "mesh"),
)
def _gray_batch_jit(dn, strategy, bit_depth, target_size, pad, mesh):
    fn = functools.partial(
        fused.grayscale_pipeline,
        strategy=strategy, bit_depth=bit_depth,
        target_size=target_size, pad=pad,
    )
    out = jax.vmap(fn)(dn)
    return jax.lax.with_sharding_constraint(
        out, NamedSharding(mesh, P("scene", "row", None))
    )


def synrgb_batch(
    vv_batch,
    vh_batch,
    mesh: Mesh,
    strategy: AutoscaleStrategy = AutoscaleStrategy.CLAHE,
    target_size: Optional[int] = 2048,
    pad: bool = False,
    channel_order: str = "rgb",
):
    """Process a batch of dual-pol scenes to synRGB across the mesh."""
    vv = shard_scene_batch(jnp.asarray(vv_batch), mesh)
    vh = shard_scene_batch(jnp.asarray(vh_batch), mesh)
    if target_size is None and not pad and channel_order == "rgb":
        with mesh:
            return _synrgb_shardmap_jit(vv, vh, strategy, mesh)
    with mesh:
        return _synrgb_batch_jit(vv, vh, strategy, target_size, pad, mesh,
                                 channel_order)


def grayscale_batch(
    dn_batch,
    mesh: Mesh,
    strategy: AutoscaleStrategy = AutoscaleStrategy.STANDARD,
    bit_depth: BitDepth = BitDepth.U8,
    target_size: Optional[int] = None,
    pad: bool = False,
):
    """Process a batch of single-pol scenes across the mesh."""
    dn = shard_scene_batch(jnp.asarray(dn_batch), mesh)
    if target_size is None and not pad:
        with mesh:
            return _gray_shardmap_jit(dn, strategy, bit_depth, mesh)
    with mesh:
        return _gray_batch_jit(dn, strategy, bit_depth, target_size, pad, mesh)
