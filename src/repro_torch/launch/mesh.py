"""Production mesh construction (the port of ``repro.launch.mesh``).

Functions, so importing this module touches no process group. The dry run
(``launch.dryrun``) initialises a fake process group of 256 or 512 ranks
first (``fake_process_group``); everything else sees the real ranks.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist


def fake_process_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks, this process rank 0:
    collectives return at once, so DTensor code traces a step of any mesh
    on one host. Replaces a fake group of another size; raises if a real
    group is initialised.

    The "fake" backend is registered by importing
    ``torch.testing._internal.distributed.fake_pg``, a module of
    PyTorch's test tree (present in torch 2.11 and 2.13, not a public
    API); the store is the public ``dist.HashStore``. If a release moves
    the module, this raises naming it."""
    try:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            f"the dry run's fake process group needs PyTorch's "
            f"torch.testing._internal.distributed.fake_pg, which torch "
            f"{torch.__version__} does not have: {e}") from e
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialised; the "
                               "dry run needs a fake one")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (data=16, model=16) = 256 devices. Multi-pod: (pod=2,
    data=16, model=16) = 512 devices. A ``DeviceMesh`` on the CPU over
    the process group's ranks (the dry run's fake ones)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {have}; the dry-run "
            f"launcher must call fake_process_group({n}) first")
    if have > n:
        from torch.distributed.device_mesh import DeviceMesh
        return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                          mesh_dim_names=axes)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device: str = "cuda"):
    """Mesh ("data", "model") over the real local devices: every CUDA
    device of the process group, or one CPU rank when ``device="cpu"``
    (the caller asks for the CPU; nothing falls back to it). Initialises a
    one-rank process group when none exists."""
    from torch.distributed.device_mesh import init_device_mesh
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: no CUDA device; pass "
                           "device='cpu' for a CPU mesh")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model={model} does not divide {n} ranks")
    return init_device_mesh(device, (n // model, model),
                            mesh_dim_names=("data", "model"))
