"""Logical-axis sharding context — the JAX package's ``models/shardctx.py``,
its no-mesh behaviour only.

Model code annotates activations with *logical* axis names ("batch",
"mlp", ...); the launcher would install a mesh and a logical-to-mesh
rule set.  Without a mesh (one card, the CPU tests) every constraint is
the identity and :func:`get_mesh` gives None, which is all the port's
models need.  Installing a mesh belongs to the mesh layer (ROADMAP A9)
and raises "not ported yet".
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

Logical = Union[str, None]


def get_mesh() -> Optional[object]:
    """The active device mesh: always None (no mesh layer yet)."""
    return None


def set_context(mesh, rules=None) -> None:
    """Clearing the context is a no-op; installing a mesh is not ported."""
    if mesh is not None:
        raise NotImplementedError("shardctx: device meshes are not ported "
                                  "yet")


def constrain(x, logical: Sequence[Logical]):
    """A sharding constraint by logical names: the identity without a
    mesh."""
    return x
