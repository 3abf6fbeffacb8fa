"""Device mesh and multi-process bootstrap (counterpart of the JAX package's
parallel/mesh.py).

A mesh is a named grid of positions, each holding a torch device:

  * ``db``   — the genome axis of the sketch database;
  * ``data`` — read batches streamed data-parallel.

In one process a mesh covers the visible cards (or one ``cpu`` position),
and the host moves blocks between positions.  In a torch.distributed
process group each rank is one position of a 1-D mesh (`Mesh.group` is
set), and blocks travel with the group's collectives: gloo between CPU
processes, NCCL between cards.

An explicit `devices` list may name one device several times; each entry
is then a position of its own that shares the device's memory.  The tests
(``["cpu"] * 8``) and chip_smoke.py (``[cuda:0] * 4``) get D > 1 positions
this way on one device; it is a way to test the multi-position paths, not a
way to run faster.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils import device as _device

DB_AXIS = "db"
DATA_AXIS = "data"

_ENV_VARS = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


class Mesh:
    """Named grid of positions: `devices` an object array of torch.device,
    `axis_names` its axes, `shape` axis name → size (as jax.sharding.Mesh's
    `.shape[axis]`).  `group` is the torch.distributed group whose ranks are
    the positions of a 1-D mesh, or None for a mesh inside one process."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], group=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.group = group

    def axis_devices(self, axis: str) -> list:
        """The positions along `axis` (the other axes at index 0): the ring
        of a 2-D mesh runs over one of its axes."""
        at = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, at, 0).reshape(self.shape[axis], -1)[:, 0])


def rank_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """The device a rank computes on: the CPU, or card rank mod the visible
    cards (several ranks share a card when there are more ranks)."""
    dev = _device.resolve(device)
    if dev.type == "cpu":
        return dev
    rank = dist.get_rank() if rank is None else rank
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_distributed(
    address: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    timeout_s: float = 600.0,
) -> bool:
    """Idempotent multi-process bootstrap; returns whether a process group
    is up.

    A no-op (False) unless `address` (``tcp://host:port``, with world_size
    and rank) is given or the env:// variables MASTER_ADDR, RANK and
    WORLD_SIZE (and MASTER_PORT) are set.  The backend is NCCL when
    `device` is CUDA and gloo on the CPU; `backend="gloo"` runs a gloo group
    whose ranks compute on cards (their blocks then travel through host
    buffers).  Under NCCL each rank's current card is set to
    rank_device(device)."""
    if dist.is_initialized():
        return True
    if address is None and not all(os.environ.get(v) for v in _ENV_VARS):
        return False
    dev = _device.resolve(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs device='cuda'")
        r = int(os.environ["RANK"]) if rank is None else rank
        torch.cuda.set_device(rank_device(dev, r))
    dist.init_process_group(backend, init_method=address or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def local_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (DB_AXIS,),
    devices: Optional[Sequence] = None,
    device="cuda",
) -> Mesh:
    """A named mesh.

    Default: in a process group, a 1-D mesh with one position per rank
    (rank r computes on rank_device(device, r)); otherwise every visible
    card for device="cuda", or one ``cpu`` position for device="cpu".
    Pass ``shape=(n_data, n_db), axis_names=("data", "db")`` for the 2-D
    layout of a DB-sharded screen, and `devices` to choose the positions
    (one device may repeat; see the module docstring)."""
    group = None
    if devices is None:
        dev = _device.resolve(device)
        if dist.is_initialized():
            group = dist.group.WORLD
            devices = [rank_device(dev, r) for r in range(dist.get_world_size())]
        elif dev.type == "cuda":
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [dev]
    else:
        devices = [_device.resolve(d) for d in devices]
    if shape is None:
        shape = (len(devices),)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    if len(shape) != len(tuple(axis_names)):
        raise ValueError(f"shape {shape} vs axis_names {tuple(axis_names)}")
    if group is not None and len(shape) != 1:
        raise ValueError("a process-group mesh is 1-D: one position per rank")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names, group)
