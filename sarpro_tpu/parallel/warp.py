"""Row-sharded on-device warp — the multi-chip path for the reference's
headline warp+synRGB config (reference: gdalwarp, sentinel1.rs:988-1071).

The warp's output tiles are independent (the inverse mapping is a pure
gather), so the output grid row-shards across the mesh's 'row' axis: every
device samples its own block of output rows against the REPLICATED source
raster. Replication is the right layout here: a reprojection may read any
part of the source from any output block (rotation, TPS), and the sampled
source is the small side — the two-stage warp in io/warp.py pre-reduces
strong downscales to ~1.25x the output before sampling.

Each shard runs io/warp.py's XLA gather sampler over its block of output
rows, with a global row offset taken from the mesh axis index — each
shard's rows are BIT-IDENTICAL to the unsharded program's (integer row
coords, exact in f32).
"""
from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

logger = logging.getLogger("sarpro")


def make_row_mesh(n: int) -> Mesh:
    from .mesh import make_mesh

    return make_mesh(n, shape=(1, n))


@functools.partial(
    jax.jit,
    static_argnames=("out_rows", "out_cols", "method", "block", "mesh"))
def _xla_sharded_call(src, map_x, map_y, out_rows: int, out_cols: int,
                      method: str, block: int, mesh: Mesh):
    from ..io.warp import _warp_sample_block

    def per_device(s, mx, my):
        row0 = jax.lax.axis_index("row") * block
        return _warp_sample_block(s, mx, my, out_rows, out_cols, method,
                                  row0, block)

    return jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P(None, None), P(None, None), P(None, None)),
        out_specs=P("row", None), check_vma=False,
    )(src, map_x, map_y)


def warp_sample_sharded(src, map_x: np.ndarray, map_y: np.ndarray,
                        out_rows: int, out_cols: int, method: str,
                        mesh: Mesh):
    """Row-sharded device sampling pass: same contract as io.warp's
    samplers, distributed over `mesh`'s 'row' axis. map grids are host
    numpy."""
    n = mesh.shape["row"]
    if n < 2:
        return None
    src = jnp.asarray(src, jnp.float32)
    block = -(-out_rows // n)
    with mesh:
        out = _xla_sharded_call(
            src, jnp.asarray(map_x, jnp.float32),
            jnp.asarray(map_y, jnp.float32),
            out_rows, out_cols, method, block, mesh)
    logger.info("Warp: XLA sampler over %d devices", n)
    return out[:out_rows]
