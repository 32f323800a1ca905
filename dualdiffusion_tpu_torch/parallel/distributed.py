"""Multi-process execution on ``torch.distributed``: one process per device,
NCCL between cards, gloo on the CPU (JAX: dualdiffusion_tpu/parallel/
distributed.py; reference: src/training/trainer.py:242-293, Accelerate's
init, ``num_processes`` and ``is_main_process``).

* ``maybe_initialize_distributed()`` starts the process group when a
  multi-process launch is configured: by its arguments, else by the JAX
  package's ``DD_COORDINATOR_ADDRESS`` (host:port, or a ``tcp://`` /
  ``file://`` URL), ``DD_NUM_PROCESSES`` and ``DD_PROCESS_ID``, else by the
  variables ``python -m torch.distributed.run`` sets (``MASTER_ADDR``,
  ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``). A rank on the
  card binds ``cuda:LOCAL_RANK``.
* ``is_main_process()`` gates files and logs to rank 0;
  ``process_count()`` and ``process_index()`` are the world size and rank
  (1 and 0 without a process group).
"""

from __future__ import annotations

import logging
import os
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 local_device_ids: Optional[Sequence[int]] = None,
                                 device="cuda", backend: Optional[str] = None,
                                 always: bool = False) -> bool:
    """Start the process group when configured; returns True when one is
    (now) running.

    Explicit arguments win, then the ``DD_*`` variables, then the launcher's.
    With one process it does nothing and returns False, as JAX's does, unless
    ``always``: then a group of one starts (over a free localhost port
    without a coordinator). ``device`` picks the backend, NCCL for "cuda"
    and gloo for "cpu", unless ``backend`` names one; on the card this rank
    binds ``cuda:<local_device_ids[0]>``, by default ``cuda:LOCAL_RANK``."""
    if dist.is_available() and dist.is_initialized():
        return True
    addr = coordinator_address or os.environ.get("DD_COORDINATOR_ADDRESS")
    n = num_processes if num_processes is not None else _env_int("DD_NUM_PROCESSES",
                                                                  "WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("DD_PROCESS_ID", "RANK")
    n = 1 if n is None else n
    if n <= 1 and not always:
        return False
    rank = rank or 0
    if addr is not None:
        init_method = addr if "://" in addr else f"tcp://{addr}"
    elif os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        init_method = "env://"
    elif n == 1:
        init_method = f"tcp://127.0.0.1:{free_port()}"
    else:
        raise ValueError(f"{n} processes but no coordinator: set DD_COORDINATOR_ADDRESS "
                         "or launch with python -m torch.distributed.run")
    dev_type = torch.device(device).type
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    if dev_type == "cuda":
        local = (local_device_ids[0] if local_device_ids
                 else _env_int("LOCAL_RANK") or 0)
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} wants cuda:{local} but "
                               f"{torch.cuda.device_count()} card(s) are visible")
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank)
    logger.info("process group: rank %d/%d over %s (%s)", rank, n, backend, init_method)
    return True


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:<current device>`` (``LOCAL_RANK`` once the
    group has bound it) for "cuda", else ``device`` itself."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank-0 gate for files and logs (the Accelerate ``is_main_process``)."""
    return process_index() == 0


def shutdown() -> None:
    """End the process group, where one runs."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
