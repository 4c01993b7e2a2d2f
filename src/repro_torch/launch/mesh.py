"""Production mesh construction, port of ``repro.launch.mesh``.

The reference builds a ``jax`` mesh of 256 or 512 forced host devices. The
port builds a ``torch.distributed`` ``DeviceMesh`` of that shape over a
*fake* process group (``torch.testing._internal.distributed.fake_pg``):
one process stands for every rank, collectives on fake tensors return
their shapes, and nothing runs on any device. This is the dry run's mesh
(``launch.dryrun``). It is not the virtual-worker mesh the mining backend
runs on (``core.runtime.shard.DeviceMesh``).

Functions, never module-level constants: importing this module touches no
process group and no device.
"""
from __future__ import annotations

import contextlib


def _shape(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def init_fake_world(world_size: int) -> None:
    """This process as rank 0 of a fake group of ``world_size`` ranks. A
    fake group already there of another size is replaced; a real one
    raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialised; the "
                               "production mesh needs a fake one")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def release_fake_world() -> None:
    """Destroy the fake group, if one is initialised."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 devices ("data", "model"); multi_pod adds the 2-pod axis
    (512: "pod", "data", "model"). Initialises the fake group of that size
    (:func:`release_fake_world` ends it; :func:`production_mesh` does both)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = _shape(multi_pod)
    n = 1
    for s in shape:
        n *= s
    init_fake_world(n)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


@contextlib.contextmanager
def production_mesh(*, multi_pod: bool = False):
    """:func:`make_production_mesh` for a block, the fake group destroyed
    after it."""
    try:
        yield make_production_mesh(multi_pod=multi_pod)
    finally:
        release_fake_world()


@contextlib.contextmanager
def counting_mesh(*, multi_pod: bool = False):
    """The mesh the dry run counts on, for a block: the production mesh,
    except that the multi-pod mesh's "pod" and "data" axes are one "data"
    axis of 32 (a 32 x 16 mesh over the same 512 ranks). Every rule of the
    reference names the two together (the data axes are one tuple in
    every spec), so each device holds the same shards; a collective over
    them is one operation instead of two, and DTensor plans for a 2-D
    mesh instead of searching a 3-D one (about 100x slower)."""
    from torch.distributed.device_mesh import init_device_mesh

    try:
        if multi_pod:
            init_fake_world(512)
            yield init_device_mesh("cpu", (32, 16),
                                   mesh_dim_names=("data", "model"))
        else:
            yield make_production_mesh()
    finally:
        release_fake_world()


def dp_axes(mesh) -> tuple:
    """The data-parallel (batch / FSDP) axes of a production mesh."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return tuple(a for a in names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"
