"""Process groups for data and edge parallelism (port of
cartnet_tpu/utils.initialize_distributed and of the process side of
cartnet_tpu/parallel/mesh.py).

The JAX package runs one controller per host over a mesh of its chips; the
port runs one process per card, each a rank of a ``torch.distributed``
process group. ``initialize_distributed`` joins the group of a multi-host
run (``--coordinator host:port``, ``--num_processes``, ``--process_id``);
``spawn`` starts the ranks of a one-host run (``--dp D --ep P``: D·P ranks,
rank r on ``cuda:r``, or on the CPU when asked). The backend follows the
device: NCCL on the card, gloo on the CPU; a caller may name one.
``rank``, ``world`` and ``is_main`` answer for the default group, or for a
process without one as a group of one.

The (dp, ep) layout mirrors ``make_mesh``'s dp-major device grid: rank r
is dp member ``r // ep`` and ep member ``r % ep``. ``make_groups`` builds
the three kinds of subgroup a model reduces over (``Groups``), once a run,
on every rank in the same order, as ``new_group`` requires.
"""

from __future__ import annotations

import dataclasses
import logging
import socket
from typing import Any, Callable, Optional

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


def check_cards(nprocs: int, device, flags: str = "") -> None:
    """One card per rank: raises when ``device`` is the card and fewer
    than ``nprocs`` are present (no fall back to the CPU); ``flags`` names
    the layout in the message (``--dp nprocs`` by default)."""
    if torch.device(device).type != "cuda":
        return
    have = torch.cuda.device_count()
    if have < nprocs:
        raise RuntimeError(f"{flags or f'--dp {nprocs}'} needs {nprocs} "
                           f"CUDA devices, {have} present")


@dataclasses.dataclass(frozen=True)
class Groups:
    """The process groups one rank's model reduces over (the JAX models'
    ``edge_stat_axes``, ``node_stat_axes`` and ``ep_axis``):

      * ``edge``: edge-level BN moments (every rank's edges are its own),
        the loss sums, the gradients and the loggers: the whole world;
      * ``node``: node-level BN moments: the ranks with this rank's ep
        index, across dp (each dp slice's nodes once), or, under halo
        partitioning (nodes sharded over ep), the whole world;
      * ``ep``: this rank's dp slice, for the partial aggregates'
        all-reduce and the halo exchanges; None when ep = 1.

    ``ep_size`` and ``ep_rank`` are the slice's size and this rank's
    index in it. ``Groups()`` is a single process: every reduction is
    local."""

    edge: Any = None
    node: Any = None
    ep: Any = None
    ep_size: int = 1
    ep_rank: int = 0

    @classmethod
    def data_parallel(cls, group) -> "Groups":
        """Data parallelism alone (ep = 1): ``group`` for edges and
        nodes."""
        return cls(edge=group, node=group)


SINGLE = Groups()


def ep_sum(t, groups: Groups):
    """The ep members' partial node sums (their edge slices' aggregates,
    the replicated-node layout) summed over ``groups.ep``, on every member,
    through the autograd-aware all-reduce, whose backward sums the
    cotangents over the members (each member's loss is its own partition).
    A bf16 partial crosses as f32 and is rounded once after the sum; ``t``
    as it is without an ep group."""
    if groups.ep is None:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t.float(), group=groups.ep).to(t.dtype)


def make_groups(dp: int, ep: int, halo: bool = False) -> Groups:
    """This rank's ``Groups`` in a world of dp·ep ranks (the default
    group), dp-major. Every rank creates every subgroup, in one order."""
    if world() != dp * ep:
        raise ValueError(f"the world has {world()} ranks; --dp {dp} --ep "
                         f"{ep} needs {dp * ep}")
    r = rank()
    world_group = dist.group.WORLD
    if ep == 1:
        return Groups.data_parallel(world_group)
    ep_groups = [dist.new_group([s * ep + m for m in range(ep)])
                 for s in range(dp)]
    # (dp = 1 without halo: the node moments are the rank's own)
    node_groups = ([dist.new_group([s * ep + m for s in range(dp)])
                    for m in range(ep)] if dp > 1 and not halo else [])
    node = world_group if halo else (node_groups[r % ep] if node_groups
                                     else None)
    return Groups(edge=world_group, node=node, ep=ep_groups[r // ep],
                  ep_size=ep, ep_rank=r % ep)


def spawn(fn: Callable, nprocs: int, args: tuple = ()) -> None:
    """Runs ``fn(rank, coordinator, *args)`` in ``nprocs`` new processes
    on this host and waits for all of them; ``coordinator`` is a free
    ``localhost:<port>``. Raises if any rank fails."""
    import torch.multiprocessing as mp
    coordinator = f"localhost:{free_port()}"
    mp.spawn(fn, args=(coordinator,) + tuple(args), nprocs=nprocs,
             join=True)
