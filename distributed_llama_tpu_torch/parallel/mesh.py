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

Sequence parallelism (the JAX mesh's ``sp`` axis): ``init_mesh`` joins an
sp x tp world (global rank = sp_index * tp + tp_index, the JAX mesh's
row-major (dp, sp, tp) order at dp 1) and makes two kinds of sub-group
with ``new_group``: a tp group a sp index (its ``group``: the forward's
collectives) and an sp group a tp index (``sp_group``: the sharded
cache's LSE combine, parallel/ring.py). Every sp rank holds its tp index's
whole weight band, and x is replicated over sp.

Data parallelism (the mesh's ``dp`` axis, training only): ``init_mesh(...,
dp=D)`` joins a dp x sp x tp world in the JAX make_mesh's row-major
(dp, sp, tp) order (global rank = (dp_index * sp + sp_index) * tp +
tp_index) and adds a dp sub-group for each (sp, tp) index (``dp_group``):
parallel/train.py sums the gradients over it. A dp rank holds the whole
tp band of its tp index and its share of the batch rows.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Any

import torch

@dataclasses.dataclass(frozen=True)
class TPGroup:
    rank: int  # the tp index: the weight band and kv heads held
    size: int  # tp
    group: Any  # a torch.distributed ProcessGroup; None at size 1
    device: torch.device
    sp_rank: int = 0  # the sp index: the cache chunk held
    sp_size: int = 1
    sp_group: Any = None  # the sp sub-group; None at sp 1
    dp_rank: int = 0  # the dp index: the batch rows held (training)
    dp_size: int = 1
    dp_group: Any = None  # the dp sub-group; None at dp 1

    @property
    def sharded(self) -> bool:
        """True where the forward is the sharded one (tp or sp above 1)."""
        return self.size > 1 or self.sp_size > 1

    @property
    def world_rank(self) -> int:
        """The global rank: (dp_index * sp + sp_index) * tp + tp_index
        (rank 0 prints, saves and serves)."""
        return (self.dp_rank * self.sp_size + self.sp_rank) * self.size \
            + self.rank

    @property
    def world_size(self) -> int:
        return self.dp_size * self.sp_size * self.size

    @property
    def backend(self) -> str:
        """'nccl', 'gloo', or 'none' for a group of one."""
        pg = next((g for g in (self.group, self.sp_group, self.dp_group)
                   if g is not None), None)
        if pg is None:
            return "none"
        import torch.distributed as dist

        return str(dist.get_backend(pg))


def single(device) -> TPGroup:
    """The group of one: the single-device program."""
    return TPGroup(0, 1, None, torch.device(device))


def visible_devices(device_type: str) -> int | None:
    """How many devices of ``device_type`` this host can give ranks: the
    visible GPUs, or None on the CPU (gloo ranks, any number)."""
    if device_type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return None


def group_backend(ranks: int, device_type: str) -> str:
    """The backend of a one-host group of ``ranks``: gloo on the CPU; on
    the card NCCL where every rank has a GPU of its own, else gloo, the
    ranks sharing the visible GPUs (init_rank puts rank r on cuda:(r mod
    n); NCCL refuses two ranks on one device). With no GPU visible it is
    NCCL, which check_tp then refuses."""
    have = visible_devices(device_type)
    return "gloo" if have is None or 0 < have < ranks else "nccl"


def check_tp(tp: int, device_type: str, num_hosts: int = 1,
             dp: int = 1) -> str | None:
    """The error of a group that does not fit (the JAX package's make_mesh
    message), or None: dp x tp ranks split evenly over the hosts, one
    device each, on no more devices than a host has."""
    if tp < 1:
        return f"--tp must be >= 1, got {tp}"
    if dp < 1:
        return f"--dp must be >= 1, got {dp}"
    if dp * tp % num_hosts:
        if dp == 1:
            return (f"--tp {tp} does not divide over {num_hosts} hosts "
                    f"(each host runs tp/num_hosts ranks)")
        return (f"mesh {dp}x1x{tp} does not divide over {num_hosts} hosts "
                f"(each host runs dp*tp/num_hosts ranks)")
    have = visible_devices(device_type)
    need = dp * tp // num_hosts
    if have is not None and need > 1 and need > have:  # one: no group
        return (f"mesh {dp}x1x{tp} needs {need} devices on this host, have "
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
              local: int | None = None, timeout_s: float = 600.0,
              backend: str | None = None) -> TPGroup:
    """Join the group as ``rank`` of ``size``: NCCL on ``cuda:local``
    (local defaults to rank), gloo on the CPU. ``backend='gloo'`` on the
    card puts rank r on cuda:(local mod the visible GPUs), so ranks may
    share one (NCCL refuses that). Nothing is switched quietly: a CUDA
    rank without its device raises."""
    import datetime

    import torch.distributed as dist

    if device_type == "cuda":
        local = rank if local is None else local
        if backend == "gloo" and torch.cuda.device_count():
            local %= torch.cuda.device_count()
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} needs cuda:{local}, have "
                               f"{torch.cuda.device_count()} GPUs")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = backend or "nccl"
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


def check_mesh(sp: int, tp: int, seq_len: int | None = None) -> str | None:
    """The error of an sp x tp mesh that does not fit the model (the JAX
    package's validate_sharding message), or None."""
    if sp < 1:
        return f"--sp must be >= 1, got {sp}"
    if seq_len is not None and seq_len % sp:
        return f"seq_len={seq_len} not divisible by sp={sp}"
    return None


def init_mesh(rank: int, sp: int, tp: int, init_method: str,
              device_type: str, local: int | None = None,
              timeout_s: float = 600.0,
              backend: str | None = None, dp: int = 1) -> TPGroup:
    """Join a dp x sp x tp world as global ``rank`` (= (dp_index * sp +
    sp_index) * tp + tp_index): init_rank over the world (``backend`` as
    there), then every rank makes every tp group (one a (dp, sp) index),
    every sp group (one a (dp, tp) index) and, at dp > 1, every dp group
    (one a (sp, tp) index) in the same order, as ``new_group`` requires,
    and keeps the ones it belongs to. At dp 1 and sp 1 this is
    init_rank."""
    world = init_rank(rank, dp * sp * tp, init_method, device_type, local,
                      timeout_s, backend)
    if sp == 1 and dp == 1:
        return world
    import datetime

    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=timeout_s)
    dp_index, rest = divmod(rank, sp * tp)
    sp_index, tp_index = divmod(rest, tp)

    def at(d, s, t):
        return (d * sp + s) * tp + t

    tp_group = sp_group = dp_group = None
    for d in range(dp):
        for s in range(sp):
            g = (dist.new_group([at(d, s, t) for t in range(tp)],
                                timeout=timeout) if tp > 1 else None)
            if (d, s) == (dp_index, sp_index):
                tp_group = g
        if sp == 1:
            continue
        for t in range(tp):
            g = dist.new_group([at(d, s, t) for s in range(sp)],
                               timeout=timeout)
            if (d, t) == (dp_index, tp_index):
                sp_group = g
    if dp > 1:
        for s in range(sp):
            for t in range(tp):
                g = dist.new_group([at(d, s, t) for d in range(dp)],
                                   timeout=timeout)
                if (s, t) == (sp_index, tp_index):
                    dp_group = g
    return TPGroup(tp_index, tp, tp_group, world.device, sp_index, sp,
                   sp_group, dp_index, dp, dp_group)


def close(group: TPGroup) -> None:
    """Leave the group (the default process group, when it is one)."""
    if group.group is None and group.sp_group is None \
            and group.dp_group is None:
        return
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
