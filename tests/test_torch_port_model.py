"""The port's CartNet eval forward and inference sweep vs the JAX package.

Same weights (JAX ``cartnet_init`` with randomized BN, moved across with
``params_from_jax``) and the same batch: the encoder output, x and e after
each layer, and the Cholesky prediction must match JAX
``cartnet_apply(training=False)`` with both Pallas kernels running (interpret
mode). Tolerances: f32 1e-4 elementwise (two layers of f32 sums in
different orders); bf16 3e-2 of the tensor's largest magnitude (bf16
roundings land in different places in the two frameworks, each worth up to
2^-8 of the value rounded, compounded over two layers; residual sums that
cancel to near zero keep the absolute error of their large terms).
e is compared under edge_mask (pad-edge rows differ by construction, see
test_torch_port_kernels.py).

Also: reference-layout state_dicts load strictly, the CLI sweep matches
``cartnet_tpu.runner.inference``, and the port stays free of JAX.
"""

import os
import pathlib
import pickle
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartnet_tpu import runner as jrunner
from cartnet_tpu.config import Config as JConfig
from cartnet_tpu.config import DataConfig as JDataConfig
from cartnet_tpu.config import ModelConfig as JModelConfig
from cartnet_tpu.data.batching import bandwidth_reorder as jreorder
from cartnet_tpu.data.batching import collate as jcollate
from cartnet_tpu.data.pipeline import BatchPipeline
from cartnet_tpu.interop import export_state_dict
from cartnet_tpu.models import cartnet as M
from cartnet_tpu.ops import rbf as jrbf
from cartnet_tpu_torch import cli
from cartnet_tpu_torch import runner as trunner
from cartnet_tpu_torch.config import ModelConfig
from cartnet_tpu_torch.data.batching import make_batches
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.interop import params_from_jax
from cartnet_tpu_torch.models.cartnet import CartNet

REPO = pathlib.Path(__file__).resolve().parents[1]
D, RBF, L = 128, 16, 2


def _assert_close(ours, ref, case, msg=""):
    a, b = _np(ours), _np(ref)
    assert a.shape == b.shape, msg
    if case == "f32":
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=msg)
    else:
        err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        assert err <= 3e-2, (msg, err)


def _jax_weights(jcfg, seed=0):
    params, state = M.cartnet_init(jax.random.key(seed), jcfg)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(seed + 100)
    for i in range(jcfg.num_layers):
        for bn in ("bn", "bn2"):  # non-trivial BN so eval BN is exercised
            d = jcfg.dim_in
            params[f"layer{i}"][bn]["gamma"] = (
                1.0 + 0.1 * rng.normal(size=d)).astype(np.float32)
            params[f"layer{i}"][bn]["beta"] = (
                0.1 * rng.normal(size=d)).astype(np.float32)
            state[f"layer{i}"][bn]["mean"] = (
                0.2 * rng.normal(size=d)).astype(np.float32)
            state[f"layer{i}"][bn]["var"] = rng.uniform(
                0.5, 2.0, d).astype(np.float32)
    return params, state


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    if isinstance(x, np.ndarray):
        return x.astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _dt(case):
    return ((jnp.bfloat16, torch.bfloat16) if case == "bf16"
            else (jnp.float32, torch.float32))


@pytest.fixture(scope="module")
def batches():
    recs = synthetic_dataset(3, mean_atoms=48, adp=True, seed=21)
    tbatch = make_batches(recs, 3)[0]
    assert (~tbatch.edge_mask[:np.flatnonzero(tbatch.edge_mask)[-1]]).any()
    jbatch = jcollate([jreorder(r) for r in recs], tbatch.num_nodes,
                      tbatch.num_edges, 3, edge_align=512)
    assert jbatch.edge_fuse_ok, "JAX must take its fused edge kernel"
    return tbatch, jax.tree.map(jnp.asarray, jbatch)


@pytest.fixture(scope="module", params=["f32", "bf16"])
def stages(request, batches):
    case = request.param
    jdt, tdt = _dt(case)
    tbatch, jbatch = batches
    jcfg = JModelConfig(dim_in=D, dim_rbf=RBF, num_layers=L,
                        compute_dtype=jdt)
    params, state = _jax_weights(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "_FORCE_SIGMA_INTERPRET", True)
        p = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt)
                         if a.dtype == np.float32 else jnp.asarray(a), params)
        st = jax.tree.map(jnp.asarray, state)
        x, e = M.encoder_apply(p["encoder"], jbatch, jcfg)
        env = jrbf.cosine_cutoff(jbatch.cart_dist.astype(x.dtype), 5.0)
        ref = [(x, e)]
        for i in range(L):
            x, e, _ = M.layer_apply(p[f"layer{i}"], st[f"layer{i}"], x, e,
                                    jbatch, jcfg, False, envelope=env)
            ref.append((x, e))
        ref_pred, _, _ = M.cartnet_apply(params, state, jbatch, jcfg,
                                         training=False)
    cfg = ModelConfig(dim_in=D, dim_rbf=RBF, num_layers=L,
                      compute_dtype=tdt)
    model = CartNet(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, state, cfg), strict=True)
    tb = tbatch.to("cpu")
    with torch.no_grad():
        x, e = model.encoder(tb, model.cast)
        env = model.envelope(tb, x.dtype)
        ours = [(x, e)]
        for layer in model.layers:
            x, e = layer(x, e, tb, env, model.cast)
            ours.append((x, e))
        pred, mask = model(tb)
    return case, tbatch, ref, ref_pred, ours, pred, mask


def test_encoder_and_layers_match_jax(stages):
    case, tbatch, ref, _, ours, _, _ = stages
    m = tbatch.edge_mask
    for i, ((x, e), (xr, er)) in enumerate(zip(ours, ref)):
        assert str(x.dtype).split(".")[-1] == str(xr.dtype), (i, x.dtype)
        assert str(e.dtype).split(".")[-1] == str(er.dtype), (i, e.dtype)
        _assert_close(x, xr, case, f"x{i}")
        _assert_close(_np(e)[m], _np(er)[m], case, f"e{i}")


def test_prediction_matches_jax(stages):
    case, tbatch, _, ref_pred, _, pred, mask = stages
    assert pred.dtype == torch.float32 and ref_pred.dtype == jnp.float32
    assert pred.shape == (tbatch.num_nodes, 3, 3)
    np.testing.assert_array_equal(mask.numpy(), tbatch.non_h_mask)
    _assert_close(pred, ref_pred, case, "pred")


def test_export_state_dict_loads_strictly(batches):
    jcfg = JModelConfig(dim_in=D, dim_rbf=RBF, num_layers=L)
    params, state = _jax_weights(jcfg, seed=3)
    cfg = ModelConfig(dim_in=D, dim_rbf=RBF, num_layers=L)
    a, b = CartNet(cfg, device="cpu"), CartNet(cfg, device="cpu", seed=9)
    a.load_state_dict(params_from_jax(params, state, cfg), strict=True)
    b.load_state_dict({k: torch.tensor(v) for k, v in
                       export_state_dict(params, state, jcfg).items()},
                      strict=True)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    tb = batches[0].to("cpu")
    with torch.no_grad():
        assert torch.equal(a(tb)[0], b(tb)[0])


def test_cli_sweep_matches_jax_runner(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jcfg = JConfig(model=JModelConfig(dim_in=D, dim_rbf=RBF, num_layers=L,
                                      use_temperature=False, cholesky=True),
                   data=JDataConfig(name="synthetic"))
    params, state = _jax_weights(jcfg.model, seed=5)
    ckpt = tmp_path / "best.ckpt"
    torch.save({"model_state": {k: torch.tensor(v) for k, v in
                                export_state_dict(params, state,
                                                  jcfg.model).items()}}, ckpt)
    out_t, out_j = tmp_path / "port.pkl", tmp_path / "jax.pkl"
    cli.main(["--device", "cpu", "--dataset", "synthetic", "--cholesky", "--limit", "8",
              "--inference", "--inference_output", str(out_t),
              "--checkpoint_path", str(ckpt), "--dim_in", str(D),
              "--dim_rbf", str(RBF), "--num_layers", str(L)])
    from cartnet_tpu.cli import load_datasets
    from cartnet_tpu.models.factory import create_model
    test_recs = load_datasets(jcfg, limit=8)[2]
    state_ns = types.SimpleNamespace(
        params=jax.tree.map(jnp.asarray, params),
        bn_state=jax.tree.map(jnp.asarray, state))
    jrunner.inference(jcfg, state_ns, create_model(jcfg.model)[1],
                      BatchPipeline(test_recs, 4), str(out_j))
    ours = pickle.loads(out_t.read_bytes())
    ref = pickle.loads(out_j.read_bytes())
    assert ours.keys() == ref.keys()
    assert len(ours["pred"]) == len(ref["pred"]) == len(test_recs)
    for k in ("true", "atoms", "pos", "cell", "temp", "refcode"):
        for a, b in zip(ours[k], ref[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("pred", "mae", "iou", "similarity_index"):
        for a, b in zip(ours[k], ref[k]):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4,
                                       err_msg=k)


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|cartnet_tpu)(\.|\s|$)", re.M)


def test_port_imports_no_jax():
    files = sorted((REPO / "cartnet_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    # the parallel layer's modules, halo and edge partitioning included
    assert {"dist.py", "step.py", "partition.py", "halo.py"} <= {
        f.name for f in files if f.parent.name == "parallel"}
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, (str(f), hits)


def test_port_forward_runs_without_jax():
    code = (
        "import sys, torch\n"
        "from cartnet_tpu_torch.config import ModelConfig\n"
        "from cartnet_tpu_torch.data.batching import make_batches\n"
        "from cartnet_tpu_torch.data.synthetic import synthetic_dataset\n"
        "from cartnet_tpu_torch.models.cartnet import CartNet\n"
        "b = make_batches(synthetic_dataset(2, mean_atoms=20, adp=True), 2)\n"
        "m = CartNet(ModelConfig(dim_in=128, dim_rbf=16, num_layers=1),\n"
        "            device='cpu')\n"
        "with torch.no_grad():\n"
        "    pred, _ = m(b[0].to('cpu'))\n"
        "assert bool(torch.isfinite(pred).all())\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = ModelConfig(dim_in=128, dim_rbf=16, num_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CartNet(cfg)
    model = CartNet(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trunner.inference(model, [], str(tmp_path / "x.pkl"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--limit", "4", "--inference"])
