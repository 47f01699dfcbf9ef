"""Production mesh definition over ``torch.distributed``'s ``DeviceMesh``.

Port of ``src/repro/launch/mesh.py``.  The reference's target is a TPU v5e
pod:

  single pod : 16 x 16 = 256 chips, axes ("data", "model")
  multi-pod  : 2 x 16 x 16 = 512 chips, axes ("pod", "data", "model")

"pod" composes with "data" for gradient reduction (batch axes are
("pod", "data")); "model" carries tensor / expert parallelism.  Here the
same meshes are ``DeviceMesh``es over an initialized process group whose
world size is the mesh's size (256 or 512 H100s, one rank each, under
``torchrun``; or the ``"fake"`` group of :func:`fake_process_group`, which
the dry run lowers against).  A mesh never shrinks to fit the group: a
missing group or a world size that differs raises.

Each mesh function takes ``device_type``: ``"cuda"`` unless the caller asks for
``"cpu"`` (the tests' ``gloo`` groups and the dry run's meta shards).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

POD_SHAPE, POD_AXES = (16, 16), ("data", "model")
MULTIPOD_SHAPE, MULTIPOD_AXES = (2, 16, 16), ("pod", "data", "model")


def _mesh(shape: tuple, axes: tuple, device_type: str) -> DeviceMesh:
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs an "
                           f"initialized process group of world size {n}")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs world "
                           f"size {n}; the process group has {world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The 16x16 ("data", "model") mesh, or 2x16x16 with "pod" ahead."""
    if multi_pod:
        return _mesh(MULTIPOD_SHAPE, MULTIPOD_AXES, device_type)
    return _mesh(POD_SHAPE, POD_AXES, device_type)


def make_host_mesh(*, device_type: str = "cuda") -> DeviceMesh:
    """Degenerate 1x1 ("data", "model") mesh over a group of one rank."""
    return _mesh((1, 1), POD_AXES, device_type)


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that carry the batch (data parallel + pod)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def axis_size(mesh, *names: str) -> int:
    out = 1
    for n in names:
        out *= mesh.size(mesh.mesh_dim_names.index(n))
    return out


def mesh_name(mesh) -> str:
    """``"16x16"``, ``"2x16x16"``, ``"1x1"``: the reference's record name."""
    return "x".join(str(s) for s in mesh.shape)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A ``"fake"`` process group of ``world_size`` ranks, this process
    being rank 0, for as long as the block runs.  Its collectives move
    nothing (they return their outputs unfilled), so it serves to lower a
    step over meta shards, never to compute one.  Raises if a group is
    already initialized; destroys its own on exit."""
    # registers the "fake" backend with torch.distributed
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def one_rank_group(backend: str):
    """A process group of this process alone (world size 1, an in-memory
    store) for as long as the block runs: what :func:`make_host_mesh`
    stands on (``"nccl"`` on the card, ``"gloo"`` on the CPU).  Raises if
    a group is already initialized; destroys its own on exit."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
