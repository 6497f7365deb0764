"""Logical-axis sharding context — the JAX package's ``models/shardctx.py``
over a torch ``DeviceMesh``.

Model code annotates activations and parameters with *logical* axis
names ("batch", "heads", "mlp", ...).  The launcher installs a mesh and a
logical-to-mesh rule set; outside any context (the CPU tests, the
meshless card phases) every constraint is the identity, so model code
never mentions physical axes.

Train rules (MaxText-style): batch over (pod, data); weights FSDP-sharded
over "data" on their reduction dim and tensor-parallel over "model" on
heads / mlp / vocab / expert dims.  Serve rules: weights replicated over
"data", KV caches batch-sharded over (pod, data) and head-sharded over
"model" (sequence-sharded where the kv heads cannot divide it).

Where the reference gives a ``PartitionSpec`` (one entry per tensor dim),
:func:`resolve` gives DTensor placements (one per mesh dim): a tensor
dim bound to mesh axes is ``Shard(dim)`` on each of them, every other
mesh dim ``Replicate()``.  A logical name bound to two axes (``batch``
over ``("pod", "data")``) is ``Shard(0)`` on both, pod first: DTensor
splits a dim over its mesh dims in mesh order, the first one major, as
JAX splits a dim over a tuple of axes.  :func:`axes_spec` turns
placements back into the reference's per-dim axis entries.  A mesh here
is anything with ``mesh_dim_names`` and ``shape`` (a ``DeviceMesh``);
:func:`constrain` and :func:`sharding_for` need a real one.
"""
from __future__ import annotations

import contextlib
import types
from typing import Dict, List, Optional, Sequence, Tuple, Union

Logical = Union[str, None]
AxisEntry = Union[None, str, Tuple[str, ...]]
# process-wide, where the reference's is thread-local: autograd runs a
# card's backward (remat's recompute of a layer included) on a device
# thread of its own, which must see the mesh the forward saw
_STATE = types.SimpleNamespace(mesh=None, rules={})


def train_rules(multi_pod: bool) -> Dict[str, Optional[Tuple[str, ...]]]:
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "fsdp": ("data",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "vocab": ("model",),
        "expert": ("model",),
    }


def serve_rules(multi_pod: bool) -> Dict[str, Optional[Tuple[str, ...]]]:
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "fsdp": None,  # replicate weights across data at decode
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "vocab": ("model",),
        "expert": ("model",),
        # KV caches: when kv_heads cannot divide the model axis (GQA with
        # few KV heads), the cache SEQUENCE dim takes the model axis.  The
        # reference's comment intends a partial softmax over the sharded
        # keys; the port gathers the keys before attending (flash
        # attention's placements, decode attention's softmax).
        "seq": ("model",),
    }


def set_context(mesh, rules: Optional[Dict]) -> None:
    _STATE.mesh = mesh
    _STATE.rules = rules or {}


def get_mesh():
    return _STATE.mesh


def get_rules() -> Dict:
    return _STATE.rules


@contextlib.contextmanager
def use_mesh(mesh, rules: Dict):
    """Install ``mesh`` and ``rules``; inside, plain tensors that meet a
    DTensor count as replicated (DTensor's ``implicit_replication``: the
    positions, masks and zero states the models make on the fly are the
    same on every rank)."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = (get_mesh(), get_rules())
    set_context(mesh, rules)
    try:
        with implicit_replication():
            yield
    finally:
        set_context(*prev)


def mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def resolve_axes(logical: Sequence[Logical],
                 shape: Optional[Sequence[int]] = None) -> List[AxisEntry]:
    """The reference's ``resolve``: one entry per tensor dim (None, an
    axis name, or a tuple of them) under the active rules.

    When ``shape`` is given, axes whose mesh extent does not divide the
    dim are dropped (kv_heads=8 over model=16, batch=1 over data):
    replication on that dim, never an error."""
    rules = get_rules()
    mesh = get_mesh()
    sizes = mesh_sizes(mesh) if mesh is not None else {}
    out: List[AxisEntry] = []
    for i, name in enumerate(logical):
        axes = rules.get(name) if name else None
        if not axes:
            out.append(None)
            continue
        if shape is not None and sizes:
            extent = 1
            for a in axes:
                extent *= sizes.get(a, 1)
            if shape[i] % extent != 0:
                out.append(None)
                continue
        out.append(axes[0] if len(axes) == 1 else tuple(axes))
    return out


def to_placements(mesh, entries: Sequence[AxisEntry]) -> tuple:
    """Per-dim axis entries -> one placement per mesh dim: ``Shard(d)``
    where tensor dim d takes that axis, ``Replicate()`` elsewhere and on
    a mesh dim of extent 1 (one device holds the whole dim; DTensor
    refuses some reshapes of a dim "sharded" over one device).  The axes
    of one entry must come in mesh order (DTensor splits a dim over its
    mesh dims in that order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(entries):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [names.index(a) for a in axes if a in names]
        if pos != sorted(pos):
            raise ValueError(f"axes {axes} of dim {d} are not in the mesh's "
                             f"order {tuple(names)}")
        for m in pos:
            if tuple(mesh.shape)[m] > 1:
                out[m] = Shard(d)
    return tuple(out)


def axes_spec(mesh, placements: Sequence, ndim: int) -> List[AxisEntry]:
    """Placements -> the reference's per-dim entries (None, one axis name,
    or a tuple of names in mesh order)."""
    from torch.distributed.tensor import Shard

    out: List[AxisEntry] = []
    for d in range(ndim):
        axes = tuple(name for name, p in zip(mesh.mesh_dim_names, placements)
                     if isinstance(p, Shard) and p.dim == d)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return out


def resolve(logical: Sequence[Logical],
            shape: Optional[Sequence[int]] = None) -> tuple:
    """Logical names -> placements on the active mesh (one per mesh dim),
    with :func:`resolve_axes`'s divisibility drop."""
    return to_placements(get_mesh(), resolve_axes(logical, shape))


def constrain(x, logical: Sequence[Logical]):
    """Redistribute a DTensor ``x`` to its logical placements; without a
    mesh, or on a plain tensor, ``x`` itself."""
    from torch.distributed.tensor import DTensor

    mesh = get_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    placements = resolve(logical, x.shape)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def sharding_for(logical: Sequence[Logical],
                 shape: Optional[Sequence[int]] = None):
    """``(mesh, placements)`` under the active context, or None."""
    mesh = get_mesh()
    if mesh is None:
        return None
    return mesh, resolve(logical, shape)
