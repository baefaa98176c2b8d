"""Device meshes: the torch counterpart of ``repro.launch.mesh``.

Functions, not module-level constants, so importing this module touches no
process group and no device. Single pod = 16×16 = 256 devices ("data",
"model"); multi-pod = 2×16×16 = 512 devices with the leading "pod" axis
spanning the (slower) inter-pod links, so batch shards over ("pod",
"data") and cross-pod traffic is gradient reduction only.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, which the caller starts: :func:`init_process_group` starts
one from the ``torchrun`` environment, or a world of one process on an
in-process store where there is none. The mesh builders never start one
behind the caller's back. The production meshes need a world of 256 or
512 processes; the tests build them under the ``fake`` process group.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def init_process_group(device_type: str = "cuda") -> int:
    """Start the default process group unless one is running; returns this
    process's rank. Under ``torchrun`` (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` set) it joins that world (on CUDA
    each process takes the card ``LOCAL_RANK``); otherwise it starts a world
    of 1 on an in-process ``HashStore`` (no port, no network). NCCL on the
    card, gloo where ``device_type`` is ``"cpu"``."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"no process group backend for device type {device_type!r}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device_type='cpu' to run on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_rank()


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """Whatever this world has (tests, examples, the launcher):
    (world / model, model) over ("data", "model")."""
    n = dist.get_world_size()
    if model <= 0 or n % model:
        raise ValueError(f"a model axis of {model} does not divide the world of {n}")
    return init_device_mesh(device_type, (n // model, model), mesh_dim_names=("data", "model"))
