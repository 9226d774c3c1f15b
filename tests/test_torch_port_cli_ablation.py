"""The port's CLI and model switches vs the JAX package: the scalar head and
the ablation branches of the reference (``--invariant``, ``--disable_temp``,
``--disable_envelope``, ``--disable_atom_types``).

* ``args_to_config`` gives the JAX CLI's head, inputs, targets and
  optimizer settings (``--fused_steps`` among them) for the same argv
  (``--dataset synthetic`` trains the scalar head on scalar targets
  unless ``--cholesky`` is passed).
* Each branch, built from the JAX package's weights through ``interop``,
  matches ``cartnet_apply`` in eval and one train micro-step of JAX
  ``make_steps`` (loss, every parameter gradient, BN running stats).

dim 32, 16 RBF, 2 layers, f32, on the batches of test_torch_port_train.py:
the JAX package takes its XLA path (no Pallas kernel is active below dim
128), the port its kernels' plain versions. Tolerances are those of the
existing port tests: eval 1e-4 elementwise (test_torch_port_model.py);
loss 1e-5 relative, gradients 5e-4 normalized, BN stats 1e-5
(test_torch_port_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartnet_tpu import cli as jcli
from cartnet_tpu.config import Config as JConfig
from cartnet_tpu.config import DataConfig as JDataConfig
from cartnet_tpu.config import ModelConfig as JModelConfig
from cartnet_tpu.config import OptimConfig as JOptimConfig
from cartnet_tpu.data.batching import collate as jcollate
from cartnet_tpu.data.synthetic import synthetic_dataset as jsynthetic
from cartnet_tpu.models import cartnet as M
from cartnet_tpu.train import loop as jloop
from cartnet_tpu.train import schedule as jsched
from cartnet_tpu_torch import cli
from cartnet_tpu_torch.config import Config, ModelConfig, OptimConfig
from cartnet_tpu_torch.data.batching import collate
from cartnet_tpu_torch.interop import params_from_jax
from cartnet_tpu_torch.models.cartnet import CartNet
from cartnet_tpu_torch.train import loop, schedule

D, RBF, L = 32, 16, 2
LR, PCT, STEPS = 3e-4, 0.1, 50

# each branch: the switches that differ from the flagship inputs
# (temperature + atom types, envelope, directions, Cholesky head)
VARIANTS = {
    "scalar_head": dict(use_temperature=False, cholesky=False),
    "scalar_no_atom_types": dict(use_temperature=False, cholesky=False,
                                 use_atom_types=False),
    "invariant": dict(invariant=True),
    "no_temperature": dict(use_temperature=False),
    "no_envelope": dict(use_envelope=False),
    "no_atom_types": dict(use_atom_types=False),
}

ARGVS = {
    "synthetic": ["--dataset", "synthetic"],
    "synthetic_cholesky": ["--dataset", "synthetic", "--cholesky"],
    "ablations": ["--dataset", "synthetic", "--invariant", "--disable_temp",
                  "--disable_envelope", "--disable_atom_types"],
    "ablations_cholesky": ["--dataset", "synthetic", "--cholesky",
                           "--invariant", "--disable_atom_types"],
    "adpfix": ["--dataset", "adpfix", "--no_standarize_temp"],
    "adpfix_no_temp": ["--dataset", "adpfix", "--disable_temp"],
    "fused_steps": ["--dataset", "synthetic", "--cholesky", "--fused_steps",
                    "4", "--batch_accumulation", "2"],
}


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b, scale=None):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.abs(b).max() if scale is None else scale
    return float(np.abs(a - b).max() / max(scale, 1e-30))


# ------------------------------------------------------------ the CLI

@pytest.mark.parametrize("argv", list(ARGVS))
def test_args_to_config_matches_jax_cli(argv):
    args = ARGVS[argv] + ["--limit", "4"]
    cfg = cli.args_to_config(cli.build_parser().parse_args(args))
    jcfg = jcli.args_to_config(jcli.build_parser().parse_args(args))
    for field in ("cholesky", "use_temperature", "invariant",
                  "use_envelope", "use_atom_types", "dim_in", "dim_rbf",
                  "num_layers", "radius"):
        assert getattr(cfg.model, field) == getattr(jcfg.model, field), \
            field
    assert cfg.data.standarize_temp == jcfg.data.standarize_temp
    for field in ("fused_steps", "batch_accumulation", "max_epoch", "lr"):
        assert getattr(cfg.optim, field) == getattr(jcfg.optim, field), \
            field
    if cfg.data.name != "synthetic":
        return
    # the same records: ADP targets [n, 3, 3] with --cholesky, else scalars
    ours = cli.load_datasets(cfg.data, 4, adp=cfg.model.cholesky)
    ref = jcli.load_datasets(jcfg, limit=4)
    for split_t, split_j in zip(ours, ref):
        assert len(split_t) == len(split_j)
        for a, b in zip(split_t, split_j):
            np.testing.assert_array_equal(np.asarray(a["y"]),
                                          np.asarray(b["y"]))
            assert np.ndim(a["y"]) == (3 if cfg.model.cholesky else 0)


def test_cli_trains_the_scalar_head_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the run dir lands under results/
    state, test = cli.main(["--device", "cpu", "--dataset", "synthetic",
                            "--limit", "8", "--epochs", "1",
                            "--batch_accumulation", "2", "--dim_in", str(D),
                            "--dim_rbf", str(RBF), "--num_layers", str(L)])
    assert not state.model.cfg.cholesky
    assert type(state.model.head).__name__ == "ScalarHead"
    assert state.step == 1 and int(state.bad_steps) == 0
    assert np.isfinite(test["MAE"]) and "iou" not in test


def test_cli_sweep_needs_the_cholesky_head(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="Cholesky"):
        cli.main(["--device", "cpu", "--dataset", "synthetic", "--limit",
                  "4", "--inference", "--dim_in", str(D), "--dim_rbf",
                  str(RBF), "--num_layers", str(L)])


# ------------------------------------------------------ the model branches

def _cfgs(variant):
    kw = dict(dict(use_temperature=True, cholesky=True), **VARIANTS[variant])
    jcfg = JConfig(model=JModelConfig(dim_in=D, dim_rbf=RBF, num_layers=L,
                                      **kw),
                   data=JDataConfig(max_nodes=64, max_edges=4096,
                                    max_graphs=2),
                   optim=JOptimConfig(lr=LR, batch_accumulation=1))
    tcfg = Config(model=ModelConfig(dim_in=D, dim_rbf=RBF, num_layers=L,
                                    **kw),
                  optim=OptimConfig(lr=LR, batch_accumulation=1))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def batches():
    """A batch of two crystals collated by both packages, per head: ADP
    targets for the Cholesky head, scalar ones for the scalar head."""
    out = {}
    for adp in (True, False):
        recs = jsynthetic(2, mean_atoms=10, radius=5.0, adp=adp, seed=21)
        out[adp] = (jax.tree.map(jnp.asarray, jcollate(recs, 64, 4096, 2)),
                    collate(recs, 64, 4096, 2).to("cpu"))
    return out


def _jax_state(jcfg):
    opt = jsched.make_optimizer(LR, STEPS, PCT)
    return opt, jloop.init_train_state(jax.random.key(3), jcfg,
                                       M.cartnet_init, opt)


def _port_model(tcfg, jstate):
    model = CartNet(tcfg.model, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.bn_state), tcfg.model), strict=True)
    return model


def _case(variant, batches):
    jcfg, tcfg = _cfgs(variant)
    return (jcfg, tcfg) + batches[jcfg.model.cholesky]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_branch_eval_matches_cartnet_apply(variant, batches):
    jcfg, tcfg, jb, tb = _case(variant, batches)
    _, jstate = _jax_state(jcfg)
    ref, ref_mask, _ = M.cartnet_apply(jstate.params, jstate.bn_state, jb,
                                       jcfg.model, training=False)
    model = _port_model(tcfg, jstate)
    with torch.no_grad():
        pred, mask = model(tb)
    assert pred.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(_np(pred), _np(ref), atol=1e-4, rtol=1e-4)


def _bn_shift_cancelled(name):
    """MLP_gate's last bias shifts the gate by a constant that train BN
    removes: its true gradient is zero (see test_torch_port_train.py)."""
    return name.endswith("MLP_gate.2.bias")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_branch_micro_step_matches_jax_make_steps(variant, batches):
    jcfg, tcfg, jb, tb = _case(variant, batches)
    opt, jstate = _jax_state(jcfg)
    model = _port_model(tcfg, jstate)
    state = loop.init_train_state(
        model, schedule.make_optimizer(model.parameters(), LR, STEPS, PCT))
    jstate, jstats = jloop.make_steps(jcfg, M.cartnet_apply, opt)[0](jstate,
                                                                    jb)
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.grad_accum),
                          jax.tree.map(np.asarray, jstate.bn_state),
                          tcfg.model)
    state, stats = loop.make_steps(tcfg)[0](state, tb)
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]),
                               rtol=1e-5)
    names = [n for n, _ in state.model.named_parameters()]
    assert len(names) == len(state.grad_accum)
    for name, g in zip(names, state.grad_accum):
        assert g.dtype == torch.float32, name
        scale = (np.abs(_np(ref[name.replace("2.bias", "2.weight")])).max()
                 if _bn_shift_cancelled(name) else None)
        assert _rel(g, ref[name], scale) <= 5e-4, (name,
                                                   _rel(g, ref[name], scale))
    for name, buf in state.model.named_buffers():
        if name.endswith("num_batches_tracked"):
            assert int(buf) == int(ref[name]) == 1, name
        else:
            assert _rel(buf, ref[name]) <= 1e-5, name
    assert int(state.accum_count) == 1 and int(state.bad_steps) == 0
