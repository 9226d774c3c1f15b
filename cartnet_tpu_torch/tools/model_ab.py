"""Bitwise A/B of a model's outputs between this tree and another checkout
of the port (an earlier commit unpacked with ``git archive``):

    python3 -m cartnet_tpu_torch.tools.model_ab DIR [--model ecomformer]
        [--device cuda|cpu] [--dim 256] [--atoms 194]

Each tree runs in a process of its own, in turns DIR, this tree, this
tree, DIR: the eval forward and one train micro-step, bf16 and f32, of the
model from seed 0 on the first batch of ``synthetic_dataset(8,
mean_atoms=atoms, adp=True, seed=0)`` in batches of 4 (the main path's
data at the defaults); every output, loss, gradient and BN buffer is
saved under ``cartnet_tpu_torch/_build/model_ab/``. Prints one JSON line:
the tensors that differ between the trees, and those that differ between
two runs of one tree (atomics), which say how far "bitwise" can go, and
each such tensor's largest gap over its largest magnitude.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

# run by each tree's own interpreter: imports the port from ROOT only
CHILD = r'''
import sys, torch
root, out, name, device, dim, atoms = sys.argv[1:7]
sys.path.insert(0, root)
import cartnet_tpu_torch
assert cartnet_tpu_torch.__file__.startswith(root), cartnet_tpu_torch.__file__
from cartnet_tpu_torch.config import Config, ModelConfig, OptimConfig
from cartnet_tpu_torch.data.batching import make_batches
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.models.factory import create_model
from cartnet_tpu_torch.train import loop
recs = synthetic_dataset(8, mean_atoms=int(atoms), radius=5.0, adp=True,
                         seed=0)
batch = make_batches(recs, 4)[0].to(device)
res = {}
for dt in (torch.bfloat16, torch.float32):
    cfg = ModelConfig(name=name, dim_in=int(dim), cholesky=True,
                      compute_dtype=dt)
    model = create_model(cfg, device, 0)
    with torch.inference_mode():
        res[f"{dt}/forward"] = model(batch)[0].cpu()
    tcfg = Config(model=cfg, optim=OptimConfig(max_epoch=1))
    state = loop.init_train_state(
        model, loop.build_optimizer(tcfg, model.parameters(), 1))
    state, stats = loop.make_steps(tcfg)[0](state, batch)
    res[f"{dt}/loss"] = stats["loss"].reshape(1).cpu()
    for (n, _), g in zip(model.named_parameters(), state.grad_accum):
        res[f"{dt}/grad/{n}"] = g.cpu()
    for n, b in model.named_buffers():
        res[f"{dt}/buffer/{n}"] = b.cpu()
torch.save(res, out)
'''


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("model_ab")
    p.add_argument("dir", help="the other tree (holds cartnet_tpu_torch/)")
    p.add_argument("--model", default="ecomformer")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--atoms", type=int, default=194)
    args = p.parse_args(argv)
    here = str(pathlib.Path(__file__).resolve().parents[2])
    other = str(pathlib.Path(args.dir).resolve())
    out_dir = pathlib.Path(here, "cartnet_tpu_torch", "_build", "model_ab")
    out_dir.mkdir(parents=True, exist_ok=True)
    outs = []
    for i, root in enumerate((other, here, here, other)):
        out = str(out_dir / f"run{i}.pt")
        subprocess.run([sys.executable, "-c", CHILD, root, out, args.model,
                        args.device, str(args.dim), str(args.atoms)],
                       check=True, env=dict(os.environ, PYTHONPATH=root))
        outs.append(out)
    import torch
    runs = [torch.load(o) for o in outs]

    def differ(a, b):
        return sorted(k for k in a if not torch.equal(a[k], b[k]))

    def gaps(a, b):
        """Each differing tensor's largest gap over b's largest magnitude,
        the largest first."""
        rel = {k: float((a[k].float() - b[k].float()).abs().max()
                        / b[k].float().abs().max().clamp_min(1e-30))
               for k in differ(a, b)}
        return dict(sorted(rel.items(), key=lambda kv: -kv[1]))

    line = {"model": args.model, "device": args.device, "dim": args.dim,
            "tensors": len(runs[0]),
            "differ_between_trees": differ(runs[0], runs[1]),
            "differ_between_runs_of_this_tree": differ(runs[1], runs[2]),
            "differ_between_runs_of_dir": differ(runs[0], runs[3]),
            "gap_between_trees": gaps(runs[1], runs[0]),
            "gap_between_runs_of_this_tree": gaps(runs[2], runs[1])}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
