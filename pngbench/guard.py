"""The run-time check that the run loaded no JAX.

The port's package name begins with the JAX package's (`fpng_tpu_torch`
and `fpng_tpu`), so a module counts by its whole top-level name, the part
before the first dot.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fpng_tpu"})


def top_level(names) -> set[str]:
    return {n.split(".", 1)[0] for n in names}


def forbidden(names=None) -> list[str]:
    """The forbidden top-level names among `names` (default: the modules
    this process has loaded)."""
    return sorted(top_level(sys.modules if names is None else names)
                  & FORBIDDEN)
