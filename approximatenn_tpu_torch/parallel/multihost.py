"""Multi-process bring-up and the global mesh (port of
``approximatenn_tpu/parallel/multihost.py``) on ``torch.distributed``.

One process a shard, on one machine or many:

    from approximatenn_tpu_torch.parallel import multihost
    multihost.initialize()            # torchrun's env, explicit args, or one local rank
    mesh = multihost.global_mesh()    # every rank of the job, one card each
    sidx = build_sharded(points, k, mesh=mesh, ...)

Per-process data loading: each rank can feed only its own rows, the
``[lo, hi)`` range :func:`host_shard_slice` gives, wrapped by
:func:`process_local_array`.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .sharded import LocalRows, Mesh, make_mesh

# torchrun's rendezvous variables (env://)
_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _cluster_env_hints() -> list[str]:
    """Environment variables whose values say this process is one of
    SEVERAL: if one is set and bring-up still fails, a silent one-process
    run would hide a misconfigured cluster, so :func:`initialize` raises.
    Presence alone is not enough (single-host TPU runtimes set
    TPU_WORKER_HOSTNAMES to the one local worker, SLURM sets its job vars
    for 1-task jobs): each hint must name more than one participant."""
    hints = [v for v in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                         "MEGASCALE_COORDINATOR_ADDRESS") if os.environ.get(v)]
    hosts = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    if len([h for h in hosts.split(",") if h.strip()]) > 1:
        hints.append("TPU_WORKER_HOSTNAMES")
    for v in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE"):
        try:
            if int(os.environ.get(v, "")) > 1:
                hints.append(v)
        except ValueError:
            pass
    return hints


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               timeout: float = 600.0) -> None:
    """Start the default process group; a no-op when one exists.

    With ``coordinator_address`` ("host:port", or a ``file://`` store
    path), ``num_processes`` and ``process_id`` it joins through that
    rendezvous (``tcp://`` for a host and port); under torchrun (its
    MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE) through ``env://``; with
    neither it starts a one-rank group on an in-process store, the JAX
    package's "stay local" run.  A failure where explicit arguments (even
    partial ones) or cluster variables said there are several processes
    raises ``RuntimeError`` rather than degrading to one process.
    ``backend``: "nccl" (the default; needs a card, and raises without
    one) or "gloo" (CPU tensors, or several ranks on one card).  Every
    collective waits at most ``timeout`` seconds."""
    if dist.is_initialized():
        return
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: pass backend='gloo' to run the process "
                               "group on the CPU")
        backend = "nccl"
    explicit = not (coordinator_address is None and num_processes is None
                    and process_id is None)
    hints = _cluster_env_hints()
    wait = datetime.timedelta(seconds=timeout)
    try:
        if explicit:
            if None in (coordinator_address, num_processes, process_id):
                raise ValueError("explicit bring-up needs coordinator_address, "
                                 "num_processes and process_id")
            url = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
            dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                    rank=process_id, timeout=wait)
        elif all(os.environ.get(v) for v in _TORCHRUN_VARS):
            dist.init_process_group(backend, init_method="env://", timeout=wait)
        elif hints:
            raise ValueError("cluster variables are set but there is no rendezvous: "
                             f"set {', '.join(_TORCHRUN_VARS)} (torchrun does) or pass "
                             "the coordinator")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                    timeout=wait)
    except (ValueError, RuntimeError) as e:
        if explicit or hints:
            raise RuntimeError(
                "torch.distributed bring-up failed in a cluster context (explicit args: "
                f"{explicit}, cluster env vars set: {hints or 'none'}); refusing to "
                "degrade to a silent single-process run") from e
        raise


def global_mesh(device=None) -> Mesh:
    """The mesh over every rank of the job (see :func:`~.sharded.make_mesh`)."""
    return make_mesh(device=device)


def host_shard_slice(n: int, mesh: Mesh | None = None) -> tuple[int, int]:
    """[lo, hi) rows of a length-n row-sharded array that this rank owns
    under ``mesh`` (default: the global mesh)."""
    mesh = mesh or global_mesh()
    if n % mesh.size:
        raise ValueError(f"n={n} not divisible by device count {mesh.size}")
    per = n // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def process_local_array(global_shape, mesh: Mesh, per_host_data) -> LocalRows:
    """Mark this rank's rows (``per_host_data``, rows
    :func:`host_shard_slice` of the global array) as already sharded: the
    sharded entry points then take them as this rank's slice of a corpus of
    ``global_shape``, which must be pre-padded to the shard count."""
    data = torch.as_tensor(per_host_data)
    shape = tuple(int(v) for v in global_shape)
    if tuple(data.shape[1:]) != shape[1:]:
        raise ValueError(f"rows of shape {tuple(data.shape)} do not fit the global "
                         f"shape {shape}")
    if shape[0] % mesh.size == 0 and data.shape[0] != shape[0] // mesh.size:
        raise ValueError(f"this rank holds {data.shape[0]} rows of a {shape[0]}-row "
                         f"corpus over {mesh.size} shards")
    return LocalRows(data=data, shape=shape)
