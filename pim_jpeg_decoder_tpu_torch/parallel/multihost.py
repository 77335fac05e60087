"""Multi-process corpus decode: whole-image sharding across processes.

Counterpart of ``pim_jpeg_decoder_tpu/parallel/multihost.py``.  The decode
is parallel at image granularity, so each process takes its own share of
the files, decodes it on its own cards and writes its own outputs; only
job metadata crosses processes, over ``torch.distributed`` with the gloo
backend (no collective is on the decode path, so no NCCL is needed).
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# How long a rank waits for the others to join (and for a collective)
# before it fails instead of blocking forever.
JOIN_TIMEOUT = datetime.timedelta(minutes=5)


def _env_int(var: str, default: int) -> int:
    try:
        return int(os.environ.get(var, default))
    except ValueError:
        return default


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Join the gloo process group (a no-op in a single-process run).

    ``coordinator_address`` is rank 0's ``host:port``.  Without explicit
    arguments the group is joined only when the environment says the job
    has more than one process: ``SLURM_NTASKS > 1`` (rank from
    ``SLURM_PROCID``), ``OMPI_COMM_WORLD_SIZE > 1`` (rank from
    ``OMPI_COMM_WORLD_RANK``) or torchrun's ``WORLD_SIZE > 1`` (rank from
    ``RANK``), each with the address from ``MASTER_ADDR`` and
    ``MASTER_PORT``.  A bare ``SLURM_JOB_ID``, ``SLURM_NTASKS=1`` or
    ``OMPI_COMM_WORLD_SIZE=1`` (one task inside an allocation) does not
    join: it would wait for ranks that never come.  An explicit
    ``num_processes <= 1`` is a no-op.  The JAX package also reads the TPU
    pod's ``TPU_WORKER_HOSTNAMES`` and ``MEGASCALE_COORDINATOR_ADDRESS``;
    they are TPU-only and not read here.  A rank that does not join
    within ``JOIN_TIMEOUT`` makes the others fail.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if num_processes is None:
        for size_var, rank_var in (("SLURM_NTASKS", "SLURM_PROCID"),
                                   ("OMPI_COMM_WORLD_SIZE",
                                    "OMPI_COMM_WORLD_RANK"),
                                   ("WORLD_SIZE", "RANK")):
            if _env_int(size_var, 1) > 1:
                num_processes = _env_int(size_var, 1)
                if process_id is None:
                    process_id = _env_int(rank_var, 0)
                break
        else:
            if coordinator_address is None:
                return  # a single-process run: nothing to join
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if not addr or not port:
            raise RuntimeError(
                f"{num_processes} processes requested but MASTER_ADDR / "
                f"MASTER_PORT are not set: give rank 0's address "
                f"(host:port) as coordinator_address or in those variables")
        coordinator_address = f"{addr}:{port}"
    if num_processes is None or process_id is None:
        raise ValueError(f"coordinator {coordinator_address!r} given without "
                         f"num_processes and process_id")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=JOIN_TIMEOUT)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


_process_index, _process_count = process_index, process_count


def partition_paths(paths: Sequence[str],
                    process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> List[str]:
    """This process's share of the corpus (strided assignment).

    Stride the list after sorting it by size (``runtime.batching.
    sort_by_size``) and per-process megapixel totals stay balanced, which
    is what the scaling-efficiency metric measures.
    """
    if process_index is None:
        process_index = _process_index()
    if process_count is None:
        process_count = _process_count()
    return list(paths[process_index::process_count])


def local_chip_count() -> int:
    return torch.cuda.device_count()
