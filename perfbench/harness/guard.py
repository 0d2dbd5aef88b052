"""The modules a run of the port may not load: JAX and the JAX package.

Names are compared by their top-level part (before the first dot), whole:
`deva_tpu_torch` is the port and passes, `deva_tpu` is the JAX package and
does not.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "deva_tpu"})


def forbidden_modules(modules=None):
    """The sorted forbidden top-level names among `modules` (by default
    sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)
