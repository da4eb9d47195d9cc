"""What a run may not have loaded: JAX, its relatives, and the JAX
package.  Names are compared whole by their top level (the part before
the first dot), so ``boofcv_tpu_torch`` is not ``boofcv_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "boofcv_tpu"})


def forbidden_loaded(modules=None) -> list:
    """Top-level names in ``modules`` (default ``sys.modules``) that are
    forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)
