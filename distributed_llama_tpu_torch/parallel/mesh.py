"""The tensor-parallel group: one process per rank (the JAX package's
parallel/mesh.py, where one controller drives a mesh of chips).

A ``TPGroup`` is what a rank needs to run its part of the forward: its
rank and the group's size, the ``torch.distributed`` process group the
collectives run over, and the one ``torch.device`` the rank owns. The CLI
builds it from its flags (``init_rank``: rank r on ``cuda:r`` over NCCL,
or a gloo rank on the CPU); a caller may build its own and pass it in (a
gloo group whose ranks share one card, as chip_smoke.py does: NCCL
refuses two ranks on one device). A group of size 1 has no process group
and runs the single-device program.

Sequence parallelism (the JAX mesh's ``sp`` axis) and data parallelism are
not ported: a group is the tp axis alone.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Any

import torch

@dataclasses.dataclass(frozen=True)
class TPGroup:
    rank: int
    size: int
    group: Any  # a torch.distributed ProcessGroup; None at size 1
    device: torch.device

    @property
    def backend(self) -> str:
        """'nccl', 'gloo', or 'none' for a group of one."""
        if self.group is None:
            return "none"
        import torch.distributed as dist

        return str(dist.get_backend(self.group))


def single(device) -> TPGroup:
    """The group of one: the single-device program."""
    return TPGroup(0, 1, None, torch.device(device))


def visible_devices(device_type: str) -> int | None:
    """How many devices of ``device_type`` this host can give ranks: the
    visible GPUs, or None on the CPU (gloo ranks, any number)."""
    if device_type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return None


def check_tp(tp: int, device_type: str, num_hosts: int = 1) -> str | None:
    """The error of a group that does not fit (the JAX package's make_mesh
    message), or None: tp ranks split evenly over the hosts, one device
    each, on no more devices than a host has."""
    if tp < 1:
        return f"--tp must be >= 1, got {tp}"
    if tp % num_hosts:
        return (f"--tp {tp} does not divide over {num_hosts} hosts (each "
                f"host runs tp/num_hosts ranks)")
    have = visible_devices(device_type)
    need = tp // num_hosts
    if have is not None and need > 1 and need > have:  # one: no group
        return (f"mesh 1x1x{tp} needs {need} devices on this host, have "
                f"{have} (visible {device_type} devices)")
    return None


def local_ranks(tp: int, num_hosts: int = 1, host_id: int = 0) -> range:
    """The tp ranks this host's processes hold: host i runs ranks
    [i*D, (i+1)*D) for D = tp / num_hosts, rank r on its local device
    r - i*D (the JAX package's local_axis_indices)."""
    per = tp // num_hosts
    return range(host_id * per, (host_id + 1) * per)


def free_port() -> int:
    """A free TCP port on localhost for a one-host group's store."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_rank(rank: int, size: int, init_method: str, device_type: str,
              local: int | None = None, timeout_s: float = 600.0) -> TPGroup:
    """Join the group as ``rank`` of ``size``: NCCL on ``cuda:local``
    (local defaults to rank), gloo on the CPU. Nothing is switched
    quietly: a CUDA rank without its device raises."""
    import datetime

    import torch.distributed as dist

    if device_type == "cuda":
        local = rank if local is None else local
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} needs cuda:{local}, have "
                               f"{torch.cuda.device_count()} GPUs")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        device = torch.device("cpu")
        backend = "gloo"
        # ranks sharing a host's cores: one intra-op thread each (eight
        # ranks of eight threads spin against each other, ~8x slower)
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return TPGroup(rank, size, dist.group.WORLD, device)


def close(group: TPGroup) -> None:
    """Leave the group (the default process group, when it is one)."""
    if group.group is None:
        return
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
