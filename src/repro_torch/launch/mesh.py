"""Process groups and device meshes: the JAX package's ``launch/mesh.py``
over ``torch.distributed`` ranks.

FUNCTIONS, not module-level state: importing this module starts no process
group.  A mesh is always passed explicitly (``make_mesh`` returns one);
nothing here sets an ambient mesh.

``init_ranks`` joins the process group of the calling process, one rank
per process.  The backend is always the caller's choice:

* ``"nccl"`` needs one card per rank (NCCL refuses two ranks on one GPU),
  so a world with more ranks than cards raises here, before the group is
  made.  Nothing ever switches to another backend on its own.
* ``"gloo"`` runs any number of ranks, on the CPU or on one card shared by
  all of them: each rank computes on its device, and the collectives move
  through host memory (``parallel.transport``).

Under ``torchrun`` (``python -m torch.distributed.run``) the rank, the
world size and the rendezvous come from its environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``);
otherwise pass ``init_method="file:///path"`` with ``rank`` and
``world_size``.
"""
from __future__ import annotations

import datetime
import math
import os

import torch
import torch.distributed as dist

from ..parallel.sharding import axis_sizes

#: How long a collective may wait for the other ranks before it raises.
DEFAULT_TIMEOUT_S = 300.0


def init_ranks(backend: str, device="cuda", *, init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group over ``backend`` and return this rank's
    device.

    ``device`` is ``"cuda"`` or ``"cpu"``.  On ``"cuda"`` rank ``LOCAL_RANK``
    takes card ``LOCAL_RANK % device_count`` (every rank shares card 0 on a
    one-card machine, which only ``"gloo"`` allows).  Raises if
    ``backend="nccl"`` is asked for a world with more ranks than there are
    cards, or for the CPU."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}; 'gloo' or 'nccl'")
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend runs on CUDA devices only")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world_size > cards:
            raise RuntimeError(
                f"nccl needs one card per rank: {world_size} ranks, {cards} "
                "card(s); name backend='gloo' to share a card")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for but no CUDA "
                               "device is present; pass device='cpu'")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if init_method is None and "MASTER_ADDR" not in os.environ:
        raise ValueError("no rendezvous: run under torchrun, or pass "
                         "init_method='file:///path'")
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def init_fake_ranks(world_size: int, rank: int = 0) -> None:
    """Join a fake process group of ``world_size`` ranks as ``rank``: no
    peers and no transport, so collectives only trace (what a capture
    needs to lay a step out on a production mesh, ``launch.dryrun``).  The
    ``"fake"`` backend is registered here if nothing has registered it."""
    from torch._C._distributed_c10d import FakeProcessGroup
    if "FAKE" not in getattr(dist.Backend, "_plugins", {}):
        def create(common_opts, backend_opts):
            make = getattr(FakeProcessGroup, "_create_internal", None)
            if make is not None:
                return make(common_opts.group_rank, common_opts.group_size,
                            backend_opts)
            return FakeProcessGroup(common_opts.group_rank,
                                    common_opts.group_size)
        dist.Backend.register_backend("fake", create, extended_api=True,
                                      devices=["cpu", "cuda"])
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=world_size)


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialized
    process group, ranks in row-major order.  Raises if the group's world
    size is not the product of ``shape``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(launch.mesh.init_ranks)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} has "
                         f"{math.prod(shape)} ranks, the world {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """(16, 16) single-pod / (2, 16, 16) two-pod production mesh.

    Axes: ``data`` carries batch DP + ZeRO-1; ``model`` carries tensor
    and expert parallelism; ``pod`` is DP across pods.  Needs a world of
    256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


#: ``{axis name: size}`` of a ``DeviceMesh`` (the reference's name).
mesh_axis_sizes = axis_sizes
