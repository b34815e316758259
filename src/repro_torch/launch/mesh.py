"""Mesh construction: the reference's ``launch/mesh.py`` over
``torch.distributed``'s :class:`~torch.distributed.device_mesh.DeviceMesh`.

A mesh spans the initialised process group, one rank a device.  The
production meshes are the reference's: one pod of (16, 16) = 256 devices
over ``("data", "model")``, or two pods, (2, 16, 16) = 512 devices over
``("pod", "data", "model")``.  One host holds no 256 cards, so the plan
(``launch/specs.py``, ``launch/dryrun.py``) builds them inside
:func:`plan_world`: a fake process group of that many ranks in one
process, rank 0, over which a mesh with ``device_type="cpu"`` touches no
device and every collective is a no-op.  The mesh functions default to
the card, as ``device.py`` says; the tests pass ``"cpu"``.

Functions only: importing this module starts no process group.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the initialised process
    group, whose world size must be the product of ``shape``."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """Single pod: (16, 16) = 256 devices (data, model).  Multi-pod:
    (2, 16, 16) = 512 devices (pod, data, model); the 'pod' axis joins the
    FSDP/data-parallel group and carries the compressed gradient
    all-reduce (``compressed_psum``) on the slow inter-pod links."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return make_mesh(shape, axes, device_type)


def make_engine_mesh(ndev: int | None = None,
                     device_type: str = "cuda") -> DeviceMesh:
    """1-D ``("data",)`` mesh over the initialised world for the
    enumeration engine: every rank is a machine M_t holding one graph
    partition.  A world of another size than ``ndev`` would change the
    partition count, so it is refused, with the reference's topology
    message."""
    if not dist.is_initialized():
        raise RuntimeError("make_engine_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    ndev = ndev or world
    if world != ndev:
        raise RuntimeError(f"device/process topology mismatch: {world} "
                           f"global devices for {ndev} processes")
    return make_mesh((ndev,), ("data",), device_type)


@contextlib.contextmanager
def plan_world(n: int):
    """A fake process group of ``n`` ranks in this process (rank 0), for
    building meshes and placements that no device backs; destroyed on
    exit.  Refuses to start beside a real group."""
    if dist.is_initialized():
        raise RuntimeError("plan_world: a process group is already "
                           "initialised; a plan needs a fake world of "
                           "its own")
    try:
        # registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "plan_world needs torch.testing._internal.distributed.fake_pg "
            "(PyTorch's fake process group), which this PyTorch lacks"
        ) from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
