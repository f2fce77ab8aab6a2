"""Multi-chip scaling: device meshes, sharded pipelines, batch parallelism.

The reference is single-process (SURVEY.md §2.5) — its concurrency is a rayon
pool and a GUI thread. Here scaling is first-class: scenes batch across chips
(the DP analogue) and rows shard within a scene (the TP/SP analogue), with
histogram reductions as XLA collectives (NCCL on GPUs).
"""
from .mesh import make_mesh  # noqa: F401
