"""Multi-process runtime setup (port of ``dcfp_tpu/parallel/distributed.py``).

The JAX package runs one process per host over every device of the job.
The port runs one process per card, PyTorch's idiom (the reference's own
``torch.distributed.launch``, engine.py:38-46):

* ``initialize()`` brings up the default ``torch.distributed`` group from
  explicit arguments (``host:port`` as a ``tcp://`` rendezvous) or from
  ``torchrun``'s environment, binds ``cuda:LOCAL_RANK`` and picks NCCL
  for CUDA and gloo for the CPU;
* ``create_pod_mesh`` is the mesh over every rank of the job;
* ``process_batch_slice`` is this rank's rows of the global batch.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from dcfp_tpu_torch.device import DeviceLike, resolve_device
from dcfp_tpu_torch.parallel.mesh import (Mesh, create_mesh, rank,
                                          world)
from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()

# A collective waits this long for its peers before the rank raises (and
# the job exits non-zero): long enough for rank 0 to write a snapshot
# while the others wait at the next step's reduce.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)

_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launched_by_torchrun() -> bool:
    """True when ``torchrun`` (or a launcher that sets its environment)
    started this process."""
    return all(k in os.environ for k in _TORCHRUN)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT,
               device: DeviceLike = None) -> None:
    """Join the job's process group (a no-op for one process).

    ``coordinator_address`` (``host:port`` of rank 0), ``num_processes``
    and ``process_id`` come from the caller; left out, they come from
    ``torchrun``'s ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``.  ``device`` (None means CUDA) sets the backend: NCCL for
    CUDA, with this process bound to ``cuda:LOCAL_RANK`` (``LOCAL_RANK``,
    else ``process_id`` modulo the visible cards: node-major ranks), and
    gloo for the CPU, unless ``backend`` names one.  ``timeout`` bounds
    every collective's wait for its peers."""
    if coordinator_address is None and launched_by_torchrun():
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
        if num_processes is None:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None:
            process_id = int(os.environ["RANK"])
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a multi-process job needs --coordinator host:port, "
            "--num-processes and --process-id, or torchrun's environment "
            "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    atexit.register(_shutdown)
    log.info("distributed: process %d/%d, backend %s, device %s",
             rank(), world(), backend,
             f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda"
             else "cpu")


def _shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return rank()


def process_count() -> int:
    return world()


def create_pod_mesh(n_spatial: int = 1,
                    dcn_data_parallel: Optional[int] = None,
                    device: DeviceLike = None) -> Mesh:
    """The ``(data, spatial)`` mesh over every rank of the job, with the
    JAX package's validation.  ``dcn_data_parallel`` (slices) only
    validates that the data axis divides into that many: NCCL picks its
    own ring or tree across nodes, where the JAX package lays the data
    axis out slice-major over DCN by hand."""
    total = world()
    if total % n_spatial:
        raise ValueError(f"{total} devices not divisible by "
                         f"n_spatial={n_spatial}")
    n_data = total // n_spatial
    if dcn_data_parallel and dcn_data_parallel > 1 \
            and n_data % dcn_data_parallel:
        raise ValueError(f"data axis {n_data} not divisible by "
                         f"{dcn_data_parallel} slices")
    return create_mesh(n_data=n_data, n_spatial=n_spatial, device=device)


def process_batch_slice(global_batch: int) -> slice:
    """The rows of the global batch this process loads."""
    per = global_batch // world()
    start = per * rank()
    return slice(start, start + per)
