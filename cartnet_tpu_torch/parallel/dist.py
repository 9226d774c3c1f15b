"""Process groups for data parallelism (port of
cartnet_tpu/utils.initialize_distributed and of the process side of
cartnet_tpu/parallel/mesh.py).

The JAX package runs one controller per host over a mesh of its chips; the
port runs one process per card, each a rank of a ``torch.distributed``
process group. ``initialize_distributed`` joins the group of a multi-host
run (``--coordinator host:port``, ``--num_processes``, ``--process_id``);
``spawn`` starts the ranks of a one-host run (``--dp N``: rank r on
``cuda:r``, or on the CPU when asked). The backend follows the device:
NCCL on the card, gloo on the CPU; a caller may name one. ``rank``,
``world`` and ``is_main`` answer for the default group, or for a process
without one as a group of one.
"""

from __future__ import annotations

import logging
import socket
from typing import Callable, Optional

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """NCCL for the card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda", backend: Optional[str] = None):
    """Joins this process to the group at ``tcp://<coordinator>`` as rank
    ``process_id`` of ``num_processes`` -> the group (the default one).
    Does nothing and returns None without a coordinator."""
    if coordinator is None:
        return None
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator needs --num_processes and "
                         "--process_id")
    dist.init_process_group(backend or backend_for(device),
                            init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    logging.info("torch.distributed initialized: rank %d of %d (%s)",
                 rank(), world(), dist.get_backend())
    return dist.group.WORLD


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def world(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def is_main(group=None) -> bool:
    return rank(group) == 0


def rank_device(device, r: int) -> torch.device:
    """Rank ``r``'s device: ``cuda:<r mod cards>`` for the card, else the
    CPU. Raises when a CUDA rank has no card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda", r % n)


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_cards(nprocs: int, device) -> None:
    """One card per rank: raises when ``device`` is the card and fewer
    than ``nprocs`` are present (no fall back to the CPU)."""
    if torch.device(device).type != "cuda":
        return
    have = torch.cuda.device_count()
    if have < nprocs:
        raise RuntimeError(f"--dp {nprocs} needs {nprocs} CUDA devices, "
                           f"{have} present")


def spawn(fn: Callable, nprocs: int, args: tuple = ()) -> None:
    """Runs ``fn(rank, coordinator, *args)`` in ``nprocs`` new processes
    on this host and waits for all of them; ``coordinator`` is a free
    ``localhost:<port>``. Raises if any rank fails."""
    import torch.multiprocessing as mp
    coordinator = f"localhost:{free_port()}"
    mp.spawn(fn, args=(coordinator,) + tuple(args), nprocs=nprocs,
             join=True)
