"""CLI: training, the ADP inference sweep and the Monte-Carlo audit, on
the card.

    python -m cartnet_tpu_torch.cli [--dataset ADP|synthetic|adpfix|jarvis|\
        dft_3d_2021|megnet] [--dataset_path ./datasets] \
        [--figshare_target formation_energy_peratom] [--max_neighbours 25] \
        [--limit N] --epochs E --batch B --batch_accumulation A \
        [--augment] [--buckets K] [--fused_steps K] [--name NAME] \
        [--seed S] [--resume] \
        [--model CartNet|eComformer|iComformer] [--cholesky] [--invariant] \
        [--disable_temp] [--no_standarize_temp] [--disable_envelope] \
        [--disable_H] [--disable_atom_types] [--bf16] [--profile] \
        [--no_guard] [--guard_retries R] [--heartbeat FILE] \
        [--heartbeat_interval S] [--wandb [--wandb_project P] \
        [--wandb_entity E]] [--dp D] [--ep P [--halo [--halo_max H]]] \
        [--chunks K] [--coordinator HOST:PORT --num_processes W \
        --process_id I] [--device cuda|cpu]
    python -m cartnet_tpu_torch.cli --dataset jarvis --verify_ingest
    python -m cartnet_tpu_torch.cli --dataset ADP --inference|--montecarlo \
        [--checkpoint_path results/NAME/S/ckpt/best.ckpt] \
        [--inference_output out.pkl] [--bf16] [--device cuda|cpu]

Flags, the synthetic splits and the run directory ``results/<name>/<seed>``
(``stats.json`` per split, ``ckpt/best.ckpt`` and ``ckpt/last.ckpt``)
mirror cartnet_tpu/cli.py, and so does the default source, ``ADP``: the
CSD thermal-ellipsoid graphs, ``<dataset_path>/csv/{train,val,test}_files.csv``
(one refcode a line) and ``<dataset_path>/data/<refcode>.pt`` (the
reference's per-structure graphs), loaded lazily (``data/adp.py``) and
fetched by a pool of 4 threads; ``--disable_H`` drops the H atoms, the
Comformers re-edge under ``--max_neighbours``, and the iComformer
canonicalizes each cell. The figshare sources read
``<dataset_path>/raw/<name>.json`` (or its zip; fetched from figshare
where the machine has a network) and cache their graphs under
``<dataset_path>``; ``--verify_ingest`` checks the payload, reports the
filter and split sizes and a few graph builds, and exits. As in the JAX
CLI, the head follows the dataset: the ADP sources and ``--cholesky``
give the Cholesky head on ADP targets; otherwise the scalar head trains
on scalar targets. The temperature input is on only for the ADP sources
(and then off with ``--disable_temp``); adpfix temperatures are
standardized unless ``--no_standarize_temp``. ``--max_neighbours`` caps
the radius graph for the Comformers (CartNet takes the uncapped graph).
``--augment`` rotates the train split each epoch (forced off for the two
Comformers, as in the JAX CLI). ``--buckets`` pads each edge-count
quantile to its own shape. ``--fused_steps K`` (K > 1) runs each train
epoch in chunks of K micro-steps, each chunk one CUDA-graph replay on the
card (one graph per pad shape; under ``--dp`` it needs NCCL) and run
eagerly on the CPU. ``--resume`` continues a run from its
``last.ckpt``. ``--profile`` traces the first train epoch into
``<run dir>/profile``; ``--heartbeat`` writes an atomic liveness file
every epoch and every ``--heartbeat_interval`` seconds; the guard rolls a
diverging run back to its last checkpoint up to ``--guard_retries`` times
(``--no_guard``: no step guard and no rollback). ``--invariant``,
``--disable_envelope`` and ``--disable_atom_types`` are the reference's
ablation switches. ``--wandb`` logs the epochs to wandb (a warning and
nothing else when wandb is missing or offline). ``--dp N`` trains
data-parallel on N ranks, one card each: without ``--coordinator`` it
starts N processes on this host (rank r on ``cuda:r``; fewer cards than N
is an error); with ``--coordinator host:port --num_processes P
--process_id I`` this process is rank I of P (one per card, on
``cuda:<I mod the host's cards>``), joined over TCP. ``--ep P`` splits
each dp member's edges over P ranks (nodes copied, the partial aggregates
summed over them), so ``--dp D --ep P`` runs D·P ranks, dp-major;
``--halo`` makes each of the P ranks own a node range and the edges into
it, exchanging the boundary rows (``--halo_max``: the rows one owner sends
one member at most); with ``--ep 1`` it runs as plain data parallelism.
``--chunks K`` (K > 1, CartNet, one process) lays each batch out in K
member-major chunks, as the JAX package's chunked execution does (its
halo layout and its chunk slack on the pads), and trains it with one
kernel call a layer over all K chunks (parallel/chunk.py says why);
under ``--dp``/``--ep`` it is ignored with a warning, ``--fused_steps``
then runs unfused epochs with a warning, and the Comformers raise.
``--model`` is case-insensitive; CartNet, the eComformer and the
iComformer all serve (``--inference`` and
``--montecarlo`` need the Cholesky head) and train. Without a checkpoint
the weights are random, drawn from ``--seed``; with one (a reference or
port ``best.ckpt``, or a state_dict the port saved), training, the sweep
and the audit start from it.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys

import torch
import torch.distributed as dist

import numpy as np

from cartnet_tpu_torch.config import (Config, DataConfig, GuardConfig,
                                      ModelConfig, OptimConfig,
                                      ParallelConfig, resolve_device)
from cartnet_tpu_torch.data.adp import ADPDataset, LazyRecords
from cartnet_tpu_torch.data.adpfix import load_fixture
from cartnet_tpu_torch.data import jarvis
from cartnet_tpu_torch.data.batching import make_batches
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.interop import load_reference_checkpoint
from cartnet_tpu_torch.models.factory import create_model
from cartnet_tpu_torch.parallel import dist as pdist
from cartnet_tpu_torch.parallel.partition import pad_multiples
from cartnet_tpu_torch.runner import (inference, montecarlo, pipelines,
                                      rank0_first, run, world_of)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("cartnet_tpu_torch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--name", type=str, default="CartNet",
                   help="run name: the run dir is results/<name>/<seed>")
    p.add_argument("--model", type=str, default="CartNet",
                   help="CartNet, eComformer or iComformer "
                        "(case-insensitive)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--dataset", type=str, default="ADP",
                   help="ADP, synthetic, adpfix, jarvis (= dft_3d_2021) or "
                        "megnet")
    p.add_argument("--dataset_path", type=str, default="./datasets",
                   help="ADP: <path>/csv and <path>/data; figshare "
                        "sources: <path>/raw and the graph cache")
    p.add_argument("--figshare_target", type=str,
                   default="formation_energy_peratom")
    p.add_argument("--max_neighbours", type=int, default=25,
                   help="radius-graph cap of the Comformers (CartNet: none)")
    p.add_argument("--fused_steps", type=int, default=0,
                   help="K > 1: K micro-steps per device launch (one CUDA "
                        "graph replay on the card)")
    p.add_argument("--buckets", type=int, default=1,
                   help="size-quantile buckets with their own pad shapes")
    p.add_argument("--verify_ingest", action="store_true",
                   help="check the figshare payload, report the filter and "
                        "split sizes and a sample graph build, then exit")
    p.add_argument("--limit", type=int, default=None,
                   help="truncate dataset (smoke runs)")
    p.add_argument("--inference", action="store_true",
                   help="run the ADP inference sweep instead of training")
    p.add_argument("--montecarlo", action="store_true",
                   help="run the Monte-Carlo rotation audit of the test "
                        "split instead of training")
    p.add_argument("--resume", action="store_true",
                   help="continue the run from results/<name>/<seed>/ckpt/"
                        "last.ckpt")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_accumulation", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup", type=float, default=0.01)
    p.add_argument("--loss", type=str, default="MAE", help="MAE or MSE")
    p.add_argument("--augment", action="store_true",
                   help="SO(3) augmentation of the train split, per epoch "
                        "(off for the Comformers)")
    p.add_argument("--inference_output", type=str, default="./inference.pkl")
    p.add_argument("--checkpoint_path", type=str, default=None,
                   help="reference or port best.ckpt, or a state_dict .pt")
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--dim_in", type=int, default=256)
    p.add_argument("--dim_rbf", type=int, default=64)
    p.add_argument("--invariant", action="store_true",
                   help="drop the edge direction from the edge features")
    p.add_argument("--disable_temp", action="store_false", dest="use_temp",
                   help="no temperature input (ADP sources only)")
    p.add_argument("--no_standarize_temp", action="store_false",
                   dest="standarize_temp",
                   help="raw temperatures for the ADP sources")
    p.add_argument("--disable_envelope", action="store_false",
                   dest="envelope", help="no cosine cutoff envelope")
    p.add_argument("--disable_H", action="store_false", dest="use_H",
                   help="drop H atoms and their edges (ADP source)")
    p.add_argument("--disable_atom_types", action="store_false",
                   dest="use_atom_types", help="no atom-type embedding")
    p.add_argument("--cholesky", action="store_true",
                   help="force the Cholesky ADP head (e.g. synthetic ADP "
                        "runs; implied by the ADP sources)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--profile", action="store_true",
                   help="trace the first train epoch (torch.profiler) into "
                        "<run dir>/profile")
    p.add_argument("--no_guard", action="store_false", dest="guard",
                   help="no device-side step guard and no rollback")
    p.add_argument("--guard_retries", type=int, default=2,
                   help="checkpoint rollbacks before a diverging run stops")
    p.add_argument("--heartbeat", type=str, default=None,
                   help="atomic JSON liveness file, written every epoch "
                        "and every --heartbeat_interval seconds")
    p.add_argument("--heartbeat_interval", type=float, default=30.0)
    p.add_argument("--wandb_project", type=str, default="ADP")
    p.add_argument("--wandb_entity", type=str, default="")
    p.add_argument("--wandb", action="store_true", help="enable wandb logging")
    p.add_argument("--dp", type=int, default=1, help="data-parallel mesh axis")
    p.add_argument("--ep", type=int, default=1, help="edge-parallel mesh axis")
    p.add_argument("--halo", action="store_true",
                   help="halo edge partitioning: shard nodes over ep too; "
                        "per-layer comms = boundary-atom all_to_all instead "
                        "of a full [N,d] all-reduce")
    p.add_argument("--halo_max", type=int, default=None,
                   help="static per-owner halo row cap (default: nodes/ep)")
    p.add_argument("--chunks", type=int, default=1,
                   help="chunked single-device execution: each batch laid "
                        "out in K member-major chunks (CartNet; ignored "
                        "under --dp/--ep)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-host: torch.distributed coordinator address "
                        "(host:port); omit on single host")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def args_to_config(args) -> Config:
    # the reference CLI's rule (cartnet_tpu/cli.py): the ADP sources carry
    # a temperature input and ADP targets; other sources (synthetic) train
    # the scalar head unless --cholesky asks for ADP targets
    adp_like = args.dataset in ("ADP", "adpfix")
    name = args.model.lower()
    model = ModelConfig(
        name=name, dim_in=args.dim_in, dim_rbf=args.dim_rbf,
        num_layers=args.num_layers, radius=args.radius,
        invariant=args.invariant,
        use_temperature=args.use_temp if adp_like else False,
        use_envelope=args.envelope, use_atom_types=args.use_atom_types,
        cholesky=adp_like or args.cholesky,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    # the reference's rule: CartNet takes the uncapped radius graph
    data = DataConfig(name=args.dataset, path=args.dataset_path,
                      target=args.figshare_target, radius=args.radius,
                      max_neighbors=-1 if name == "cartnet"
                      else args.max_neighbours,
                      batch_size=args.batch,
                      augment=args.augment and name not in ("ecomformer",
                                                            "icomformer"),
                      standarize_temp=args.standarize_temp,
                      use_hydrogens=args.use_H,
                      optimize_cell=name == "icomformer",
                      buckets=args.buckets)
    optim = OptimConfig(lr=args.lr, max_epoch=args.epochs,
                        warmup=args.warmup,
                        batch_accumulation=args.batch_accumulation,
                        loss=args.loss, fused_steps=args.fused_steps)
    guard = GuardConfig(enabled=args.guard, max_retries=args.guard_retries,
                        heartbeat_path=args.heartbeat,
                        heartbeat_interval=args.heartbeat_interval)
    par = ParallelConfig(dp=args.dp, ep=args.ep, halo=args.halo,
                         halo_max=args.halo_max, chunks=args.chunks)
    return Config(model=model, data=data, optim=optim, parallel=par,
                  guard=guard, seed=args.seed, name=args.name,
                  run_dir=os.path.join("results", args.name, str(args.seed)))


FIGSHARE = ("jarvis", "dft_3d_2021", "megnet")


def load_datasets(data: DataConfig, limit=None, adp: bool = True):
    """(train, val, test) record sources. ``ADP``: a ``LazyRecords`` over
    each split's csv of refcodes and their ``.pt`` graphs under
    ``data.path`` (the first ``limit`` of each split). ``adpfix``: the frozen fixture
    (200 / 20 / 20, ``limit`` cuts to limit / k / k). The figshare sources
    (``jarvis`` = ``dft_3d_2021``, ``megnet``): ``jarvis.build_dataset``
    on ``data.path`` (the seed-123 split, ``limit`` cuts to limit /
    limit // 8 / limit // 8).
    ``synthetic``: the reference CLI's records (seed 123, ~32 atoms per
    crystal), sizes n / k / k with n = limit (default 128); ADP targets
    with ``adp`` (the Cholesky head), else one scalar per crystal. k =
    max(n // 4, 2)."""
    if data.name == "ADP":
        return tuple(LazyRecords(ADPDataset(
            os.path.join(data.path, "data"),
            os.path.join(data.path, "csv", f"{split}_files.csv"),
            standarize_temp=data.standarize_temp,
            hydrogens=data.use_hydrogens, optimize_cell=data.optimize_cell,
            max_neighbors=data.max_neighbors, radius=data.radius),
            limit=limit) for split in ("train", "val", "test"))
    if data.name == "adpfix":
        return load_fixture(standarize_temp=data.standarize_temp,
                            limit=limit)
    if data.name in FIGSHARE:
        return jarvis.build_dataset(data.name, data.target, data.path,
                                    data.radius, data.max_neighbors,
                                    limit=limit)
    if data.name != "synthetic":
        raise ValueError(f"dataset {data.name!r} not implemented")
    n = limit or 128
    k = max(n // 4, 2)
    recs = synthetic_dataset(n + 2 * k, mean_atoms=32, radius=data.radius,
                             adp=adp, seed=123)
    return recs[:n], recs[n:n + k], recs[n + k:n + 2 * k]


def _dp_rank(rank: int, coordinator: str, argv: list, nprocs: int) -> None:
    """Rank ``rank`` of a one-host ``--dp`` run (``pdist.spawn``)."""
    main(list(argv) + ["--coordinator", coordinator, "--num_processes",
                       str(nprocs), "--process_id", str(rank)])


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    cfg = args_to_config(args)
    if args.verify_ingest:
        return verify_ingest(cfg)
    dp, ep = cfg.parallel.dp, max(cfg.parallel.ep, 1)
    nprocs = dp * ep
    if args.coordinator is None and nprocs > 1:
        # one host: start the ranks, one card each, and wait for them
        resolve_device(args.device)
        pdist.check_cards(nprocs, args.device,
                          f"--dp {dp} --ep {ep}" if ep > 1 else "")
        if args.montecarlo:
            raise ValueError("--montecarlo runs in one process (--dp 1)")
        pdist.spawn(_dp_rank, nprocs, (argv, nprocs))
        return None
    device, group = args.device, None
    if args.coordinator is not None:
        if nprocs not in (1, args.num_processes) or \
                args.num_processes % ep:
            raise ValueError(f"--dp {dp} --ep {ep} differs from "
                             f"--num_processes {args.num_processes}")
        if args.montecarlo:
            raise ValueError("--montecarlo runs in one process (--dp 1)")
        device = resolve_device(pdist.rank_device(args.device,
                                                  args.process_id))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        world = pdist.initialize_distributed(
            args.coordinator, args.num_processes, args.process_id, device)
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, dp=pdist.world(world) // ep, ep=ep))
        group = pdist.make_groups(cfg.parallel.dp, ep, cfg.parallel.halo)
    try:
        return _serve_or_train(args, cfg, resolve_device(device), group)
    finally:
        if group is not None:
            dist.destroy_process_group()


def _serve_or_train(args, cfg: Config, device, group):
    """Training, the inference sweep or the Monte-Carlo audit (``main``
    after the process group is set up)."""
    state_dict = None
    if args.checkpoint_path:
        state_dict = load_reference_checkpoint(args.checkpoint_path)
        logging.info("loaded checkpoint %s", args.checkpoint_path)
    splits = load_datasets(cfg.data, args.limit, adp=cfg.model.cholesky)
    if not (args.inference or args.montecarlo):
        return run(cfg, splits, device, state_dict, resume=args.resume,
                   profile=args.profile, group=group,
                   wandb=dict(project=args.wandb_project,
                              entity=args.wandb_entity)
                   if args.wandb else None)
    model = create_model(cfg.model, device, args.seed)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    if args.montecarlo:
        return montecarlo(cfg, model, pipelines(cfg, splits)[2],
                          args.inference_output, device=device)
    # a lazy source streams through its pipeline; a record list is
    # batched as it is, unless --chunks asks for the pipeline's chunk pads
    batches = (make_batches(splits[2], cfg.data.batch_size,
                            *pad_multiples(cfg.parallel.ep))
               if isinstance(splits[2], list) and cfg.parallel.chunks <= 1
               else rank0_first(world_of(group),
                                lambda: pipelines(cfg, splits))[2])
    return inference(model, batches, args.inference_output, device, group,
                     cfg.parallel.halo, cfg.parallel.halo_max)


def verify_ingest(cfg: Config) -> dict:
    """--verify_ingest: check the raw figshare payload (the archive's
    checksum or CRC where a zip is there), report the filter and split
    sizes and three sample graph builds, then exit (no training) ->
    those sizes."""
    name = cfg.data.name
    if name not in FIGSHARE:
        raise ValueError(f"--verify_ingest supports figshare datasets only "
                         f"(got {name!r})")
    raw_name = "dft_3d_2021" if name == "jarvis" else name
    zip_path = os.path.join(cfg.data.path, "raw", f"{raw_name}.zip")
    if os.path.exists(zip_path):
        logging.info("archive integrity: %s",
                     jarvis.verify_archive(raw_name, zip_path))
    data = jarvis.load_raw(name, cfg.data.path)
    logging.info("raw records: %d", len(data))
    dat, targets = jarvis.filter_by_target(data, cfg.data.target)
    tr, va, te = jarvis.split_123(len(dat))
    logging.info("target %r: %d usable -> split %d/%d/%d (seed-123 "
                 "protocol)", cfg.data.target, len(dat), len(tr), len(va),
                 len(te))
    for i in range(min(3, len(dat))):
        rec = jarvis.atoms_to_record(dat[i]["atoms"],
                                     np.float32(targets[i]).item()
                                     if np.ndim(targets[i]) == 0
                                     else targets[i],
                                     radius=cfg.data.radius)
        logging.info("sample %d: %d atoms, %d edges, finite=%s", i,
                     len(rec["z"]), len(rec["edge_src"]),
                     bool(np.isfinite(rec["cart_dist"]).all()))
    logging.info("verify_ingest OK")
    return {"raw": len(data), "usable": len(dat),
            "split": (len(tr), len(va), len(te))}


if __name__ == "__main__":
    main()
