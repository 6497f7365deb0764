"""Device meshes — the JAX package's ``launch/mesh.py`` over
``torch.distributed``.

The meshes are FUNCTIONS (never module-level constants), so importing
this module never touches ``torch.distributed``: the dry-run opens its
fake 256- or 512-rank process group before it builds a mesh.

``make_production_mesh`` is the reference's target layout, (16, 16) with
axes ("data", "model") or (2, 16, 16) with ("pod", "data", "model"),
over the default process group, one rank a device: it needs a group of
256 or 512 ranks, and raises where the group is another size.
``make_debug_mesh`` is the small mesh over the ranks there are, opening a
one-rank group first where none is open: on one card that is the (1, 1)
mesh over ``cuda:0``.
"""
from __future__ import annotations

import socket
from typing import Optional, Tuple

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ensure_process_group(device_type: str = "cuda") -> bool:
    """Open the default group unless one is open (NCCL for the card, gloo
    for the CPU): from the environment where a launcher such as
    ``torchrun`` set ``WORLD_SIZE``, else a one-rank group.  True where
    this call opened it."""
    import os

    import torch.distributed as dist

    if dist.is_initialized():
        return False
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{free_port()}",
            world_size=1, rank=0)
    return True


def _mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    import torch.distributed as dist

    shape, names = PRODUCTION[bool(multi_pod)]
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"the {'x'.join(map(str, shape))} production mesh needs a "
            f"process group of {need} ranks, one a device; "
            + (f"the default group has {have}" if have else
               "no process group is open")
            + " (python -m repro_torch.launch.dryrun runs it on a fake "
              "group)")
    return _mesh(device_type, shape, names)


def make_debug_mesh(n_devices: Optional[int] = None,
                    device_type: str = "cuda"):
    """(2, n // 2) over n >= 4 ranks, else (1, n): ("data", "model")."""
    import torch.distributed as dist

    ensure_process_group(device_type)
    n = n_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise RuntimeError(f"a debug mesh of {n} devices needs a group of "
                           f"{n} ranks, not {dist.get_world_size()}")
    if n >= 4:
        return _mesh(device_type, (2, n // 2), ("data", "model"))
    return _mesh(device_type, (1, n), ("data", "model"))


def mesh_info(mesh) -> Tuple[int, dict]:
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    n = 1
    for v in sizes.values():
        n *= v
    return n, sizes
