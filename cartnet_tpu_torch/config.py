"""Immutable typed configuration (port of cartnet_tpu/config.py).

What the inference sweep and the trainer read: the model hyperparameters,
the data settings (synthetic, adpfix, CSD ADP and figshare sources,
hydrogens, the iComformer's cell canonicalization, augmentation, size
buckets), the optimizer/schedule, the parallel layout (data- and
edge-parallel ranks, halo partitioning, chunked execution), the step
guard (device-side skip, host-side rollback, heartbeat), and the run's
name and directory (``results/<name>/<seed>`` from the CLI: stats.json
files and checkpoints). Dtypes are torch dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters (reference defaults)."""

    name: str = "cartnet"  # cartnet | ecomformer | icomformer (factory)
    dim_in: int = 256
    dim_rbf: int = 64
    num_layers: int = 4
    radius: float = 5.0
    invariant: bool = False
    use_temperature: bool = True
    use_envelope: bool = True
    use_atom_types: bool = True
    cholesky: bool = True  # Cholesky ADP head vs scalar head
    # numerics: params are stored in param_dtype and cast to compute_dtype
    # once per forward; BN running stats stay in param_dtype
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset / batching settings."""

    name: str = "synthetic"  # synthetic | adpfix | ADP | jarvis | megnet ...
    path: str = "./datasets"  # ADP: <path>/{csv,data}; figshare: <path>/raw
    target: str = "formation_energy_peratom"  # figshare target column
    radius: float = 5.0
    max_neighbors: int = -1  # radius-graph cap (-1: none; CartNet)
    batch_size: int = 4
    # per-epoch SO(3) augmentation of the train split
    augment: bool = False
    # standardize the ADP sources' temperatures (--no_standarize_temp
    # turns it off)
    standarize_temp: bool = True
    # ADP source: keep H atoms (--disable_H drops them and their edges)
    use_hydrogens: bool = True
    # ADP source: canonicalize each lattice (the iComformer's)
    optimize_cell: bool = False
    # size-quantile buckets, each with its own pad shape (1: one shape)
    buckets: int = 1


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Adam + OneCycle (PyTorch OneCycleLR defaults mirrored)."""

    lr: float = 1e-3
    max_epoch: int = 50
    warmup: float = 0.01  # OneCycle pct_start
    batch_accumulation: int = 1
    loss: str = "MAE"  # MAE | MSE
    div_factor: float = 25.0
    final_div_factor: float = 1e4
    cycle_momentum: bool = True
    base_momentum: float = 0.85
    max_momentum: float = 0.95
    grad_clip: Optional[float] = None
    # fused epochs: K > 1 micro-steps per device launch (one CUDA-graph
    # replay on the card, train/graphs.py); K <= 1 runs unfused epochs
    fused_steps: int = 0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The parallel layout (parallel/): ``dp`` data-parallel slices of
    ``ep`` edge-parallel ranks each, one card a rank; ``halo`` shards each
    slice's nodes over its ep ranks too (``halo_max``: the rows one owner
    sends one member at most, n_per by default). ``chunks`` > 1: chunked
    single-device execution (parallel/chunk.py), each batch laid out in
    that many member-major chunks."""

    dp: int = 1
    ep: int = 1
    halo: bool = False
    halo_max: Optional[int] = None
    chunks: int = 1


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Failure detection and recovery (train/guard.py): the device-side
    non-finite step guard, the host-side rollback and the heartbeat."""

    enabled: bool = True  # step guard and divergence rollback
    max_bad_fraction: float = 0.5  # epoch bad-step share that rolls back
    max_retries: int = 2  # rollbacks before the run raises
    heartbeat_path: Optional[str] = None  # atomic liveness file (None: off)
    heartbeat_interval: float = 30.0


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)
    guard: GuardConfig = dataclasses.field(default_factory=GuardConfig)
    seed: int = 0
    name: str = "CartNet"
    run_dir: str = "results"


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. The card is the default; without
    one, only an explicit ``device="cpu"`` runs. Also pins f32 matmuls and
    convolutions to full f32 precision (no TF32)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
