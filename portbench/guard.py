"""The import guard: no run of the benchmark may load JAX or the JAX
package.  Each loaded module's top-level name (the part before the first
dot) is compared whole, so ``softgroup_tpu_torch`` is not
``softgroup_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset(('jax', 'jaxlib', 'flax', 'softgroup_tpu'))


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: what
    this process has loaded)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split('.')[0] for m in names} & FORBIDDEN)
