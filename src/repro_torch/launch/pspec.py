"""The one divisibility rule of tensor parallelism (port of the JAX
package's ``launch/pspec.py``, whose logical-axis ``shard`` annotations
GSPMD reads; the port places every tensor itself, so only the rule is
left).

Every decision to cut a dimension over mesh axes or to replicate it goes
through :func:`axis_divides`, and only ``launch/specs.param_pspecs``
decides: the serving plan, the shard's config and with it the KV pool and
the dense cache read its specs, so that the decisions cannot drift
apart.
"""
from __future__ import annotations


def axis_divides(mesh, axes, dim: int) -> bool:
    """True iff ``dim`` is divisible by the product of the named mesh axes
    (``axes``: one name or a tuple).  ``mesh`` has ``axis_names`` and
    ``shape`` (the sizes, in that order)."""
    names = axes if isinstance(axes, tuple) else (axes,)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    total = 1
    for n in names:
        total *= sizes[n]
    return dim % total == 0
