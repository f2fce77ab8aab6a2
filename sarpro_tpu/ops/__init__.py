"""Device operations of the per-pixel chain: histograms and CLAHE/synRGB
table lookups (plain XLA)."""
from .kernels import (  # noqa: F401
    clahe_lookup,
    histogram,
    synrgb_lookup,
    tile_histogram,
)
