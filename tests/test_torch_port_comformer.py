"""The port's eComformer eval forward and its modules vs the JAX package.

Same weights (JAX ``ecomformer_init`` with randomized BN, moved across with
``ecomformer_params_from_jax``) and the same batch (two crystals of ~48
atoms, per-graph edge alignment 512, pads on each graph's last node). The
JAX side runs K1 and K2 in interpret mode (``_FORCE_SIGMA_INTERPRET``) and
K7 as the Pallas kernel in interpret mode (``tp_kernel_ok`` forced, the
entries wrapped with ``interpret=True``); its K3 call site falls back to
XLA's segment_sum on the CPU. Compared: the spherical harmonics, the eval
conv, the eval equivariant block and the whole forward.

Tolerances: f32 1e-4 normalized (sums in other orders over three convs and
the block); bf16 3e-2 of the tensor's largest magnitude (bf16 roundings
land in different places in the two frameworks, each worth up to 2^-8 of
the value rounded, compounded over the layers). Dtypes must be equal.

Also: rotation invariance of the port's prediction, the CLI sweep against
``cartnet_tpu.runner.inference``, and the model names the factory takes.
"""

import os
import pathlib
import pickle
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
from cartnet_tpu.models import cartnet as jcartnet
from cartnet_tpu.models import comformer as JC
from cartnet_tpu.models import equivariant as JE
from cartnet_tpu.nn import core as jcore
from cartnet_tpu.ops import sh as jsh
from cartnet_tpu.ops.pallas import tp_kernels as jtp
from cartnet_tpu_torch import cli
from cartnet_tpu_torch.config import ModelConfig
from cartnet_tpu_torch.data.batching import make_batches
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.interop import ecomformer_params_from_jax
from cartnet_tpu_torch.models import comformer as cm
from cartnet_tpu_torch.models.comformer import EComformer, IComformer
from cartnet_tpu_torch.models.factory import create_model
from cartnet_tpu_torch.nn.core import Params, cast_params
from cartnet_tpu_torch.ops.sh import spherical_harmonics_l012

REPO = pathlib.Path(__file__).resolve().parents[1]
D = 128


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(ours, ref, case, msg=""):
    a, b = _np(ours), _np(ref)
    assert a.shape == b.shape, msg
    err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    assert err <= (1e-4 if case == "f32" else 3e-2), (msg, err)


def _same_dtype(t, j, msg=""):
    assert str(t.dtype).split(".")[-1] == str(j.dtype), (msg, t.dtype,
                                                         j.dtype)


def _dt(case):
    return ((jnp.bfloat16, torch.bfloat16) if case == "bf16"
            else (jnp.float32, torch.float32))


def _jax_weights(jcfg, seed=0):
    params, state = JC.ecomformer_init(jax.random.key(seed), jcfg)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(seed + 100)
    bns = [(f"conv{i}", bn) for i in range(3) for bn in ("bn", "bn_att")]
    for mod, bn in bns + [("equi", "bn")]:  # non-trivial eval BN
        n = params[mod][bn]["gamma"].shape[0]
        params[mod][bn]["gamma"] = (1.0 + 0.1 * rng.normal(size=n)).astype(
            np.float32)
        params[mod][bn]["beta"] = (0.1 * rng.normal(size=n)).astype(
            np.float32)
        state[mod][bn]["mean"] = (0.2 * rng.normal(size=n)).astype(
            np.float32)
        state[mod][bn]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return params, state


@pytest.fixture(scope="module")
def jax_kernels():
    """The JAX package's K1/K2/K7 in interpret mode on the CPU."""
    l1, l2 = jtp.tp_contract_l1, jtp.tp_contract_l2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcartnet, "_FORCE_SIGMA_INTERPRET", True)
        mp.setattr(jtp, "tp_kernel_ok", lambda E, C: True)
        mp.setattr(jtp, "tp_contract_l1",
                   lambda h, a, W, b: l1(h, a, W, b, True))
        mp.setattr(jtp, "tp_contract_l2",
                   lambda h, a0, a1, a2, W, b: l2(h, a0, a1, a2, W, b, True))
        yield


@pytest.fixture(scope="module")
def batches():
    recs = synthetic_dataset(2, mean_atoms=48, adp=True, seed=21)
    tbatch = make_batches(recs, 2)[0]
    assert (~tbatch.edge_mask[:np.flatnonzero(tbatch.edge_mask)[-1]]).any()
    jbatch = jcollate([jreorder(r) for r in recs], tbatch.num_nodes,
                      tbatch.num_edges, 2, edge_align=512)
    assert jbatch.edge_fuse_ok and jbatch.pallas_seg_ok
    return tbatch, jax.tree.map(jnp.asarray, jbatch)


@pytest.fixture(scope="module")
def weights():
    jcfg = JModelConfig(name="ecomformer", dim_in=D, cholesky=True)
    params, state = _jax_weights(jcfg)
    sd = ecomformer_params_from_jax(params, state,
                                    ModelConfig(name="ecomformer", dim_in=D))
    return jcfg, params, state, _model(sd, torch.float32)


def _model(sd, tdt):
    model = EComformer(ModelConfig(name="ecomformer", dim_in=D,
                                   compute_dtype=tdt), device="cpu", seed=9)
    model.load_state_dict(sd, strict=True)
    return model


def _cast(params, jdt):
    return jcore.cast_params(jax.tree.map(jnp.asarray, params), jdt,
                             jnp.float32)


@pytest.fixture(scope="module", params=["f32", "bf16"])
def forward(request, jax_kernels, batches, weights):
    case = request.param
    jdt, tdt = _dt(case)
    tbatch, jbatch = batches
    jcfg, params, state, model = weights
    jcfg = JModelConfig(name="ecomformer", dim_in=D, cholesky=True,
                        compute_dtype=jdt)
    ref_pred, ref_mask, _ = JC.ecomformer_apply(
        params, jax.tree.map(jnp.asarray, state), jbatch, jcfg,
        training=False)
    with torch.no_grad():
        pred, mask = _model(model.state_dict(), tdt)(tbatch.to("cpu"))
    return case, tbatch, ref_pred, ref_mask, pred, mask


def test_spherical_harmonics_match_jax():
    v = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    v[0] = 0.0  # pad edges carry a zero direction
    for ours, ref in zip(spherical_harmonics_l012(torch.tensor(v)),
                         jsh.spherical_harmonics_l012(jnp.asarray(v))):
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(_np(ours), _np(ref), atol=1e-6,
                                   rtol=1e-6)


def test_rbf_expansion_matches_jax():
    from cartnet_tpu.ops import rbf as jrbf
    from cartnet_tpu_torch.ops import rbf as trbf
    c, g = trbf.rbf_expansion_params(-4.0, 0.0, 64)
    jc, jg = jrbf.rbf_expansion_params(-4.0, 0.0, 64)
    np.testing.assert_allclose(_np(c), np.asarray(jc), rtol=1e-6, atol=1e-6)
    assert c.shape == (64,) and g.shape == () and float(g) == jg
    x = -0.75 / np.random.default_rng(1).uniform(0.8, 5.0, 50).astype(
        np.float32)
    np.testing.assert_allclose(
        _np(trbf.rbf_expansion(torch.tensor(x), c, g)),
        np.asarray(jrbf.rbf_expansion(jnp.asarray(x), jc, jg)), rtol=1e-5,
        atol=1e-6)


def _node_edge_inputs(tbatch, xdt, edt, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(tbatch.num_nodes, D)).astype(np.float32)
    e = np.abs(rng.normal(size=(tbatch.num_edges, D))).astype(np.float32)
    jx, je = jnp.asarray(x, xdt), jnp.asarray(e, edt)
    return (jx, je, torch.tensor(_np(jx)).to(_dt_t(xdt)),
            torch.tensor(_np(je)).to(_dt_t(edt)))


def _dt_t(jdt):
    return torch.bfloat16 if jdt == jnp.bfloat16 else torch.float32


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_conv_matches_jax(jax_kernels, batches, weights, case):
    # the bf16 case is conv0's: bf16 node features and edges
    jdt, tdt = _dt(case)
    tbatch, jbatch = batches
    jcfg, params, state, model = weights
    jx, je, tx, te = _node_edge_inputs(tbatch, jdt, jdt, 1)
    ref, _ = JC.conv_apply(_cast(params, jdt)["conv0"],
                           jax.tree.map(jnp.asarray, state["conv0"]), jx, je,
                           jbatch, jcfg, False)
    p = Params(cast_params(model, tdt, torch.float32))
    with torch.no_grad():
        ours = model.conv0(tx, te, tbatch.to("cpu"), p.sub("conv0"))
    _same_dtype(ours, ref)
    _close(ours, ref, case, "conv0")


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_equivariant_block_matches_jax(jax_kernels, batches, weights, case):
    # in a bf16 forward the block sees f32 x (after conv0's eval BN) and
    # bf16 edges
    jdt, tdt = _dt(case)
    tbatch, jbatch = batches
    jcfg, params, state, model = weights
    jx, je, tx, te = _node_edge_inputs(tbatch, jnp.float32, jdt, 2)
    ref, _ = JE.equi_block_apply(_cast(params, jdt)["equi"],
                                 jax.tree.map(jnp.asarray, state["equi"]),
                                 jx, je, jbatch, jcfg, False)
    p = Params(cast_params(model, tdt, torch.float32))
    with torch.no_grad():
        ours = model.equi(tx, te, tbatch.to("cpu"), p.sub("equi"))
    _same_dtype(ours, ref)
    _close(ours, ref, case, "equi")


def test_forward_matches_jax(forward):
    case, tbatch, ref_pred, ref_mask, pred, mask = forward
    assert pred.dtype == torch.float32 and ref_pred.dtype == jnp.float32
    assert pred.shape == (tbatch.num_nodes, 3, 3)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    m = tbatch.non_h_mask
    _close(_np(pred)[m], _np(ref_pred)[m], case, "pred")


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return (q if np.linalg.det(q) > 0 else -q).astype(np.float32)


def test_prediction_is_rotation_invariant(batches):
    tbatch, _ = batches
    model = EComformer(ModelConfig(name="ecomformer", dim_in=D), "cpu",
                       seed=3)
    R = torch.tensor(_rotation(7))
    tb = tbatch.to("cpu")
    rot = tbatch.to("cpu")
    rot.cart_dir = tb.cart_dir @ R
    rot.cell = tb.cell @ R
    with torch.no_grad():
        p1, m1 = model(tb)
        p2, m2 = model(rot)
    assert torch.equal(m1, m2)
    np.testing.assert_allclose(_np(p1)[_np(m1) > 0], _np(p2)[_np(m2) > 0],
                               rtol=1e-3, atol=1e-5)


def test_cli_sweep_matches_jax_runner(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jcfg = JConfig(model=JModelConfig(name="ecomformer", dim_in=D,
                                      use_temperature=False, cholesky=True),
                   data=JDataConfig(name="synthetic"))
    params, state = _jax_weights(jcfg.model, seed=5)
    ckpt = tmp_path / "ecomformer.pt"
    torch.save(ecomformer_params_from_jax(
        params, state, ModelConfig(name="ecomformer", dim_in=D)), ckpt)
    out_t, out_j = tmp_path / "port.pkl", tmp_path / "jax.pkl"
    cli.main(["--device", "cpu", "--dataset", "synthetic", "--cholesky", "--limit", "8",
              "--inference", "--model", "eComformer", "--inference_output",
              str(out_t), "--checkpoint_path", str(ckpt), "--dim_in",
              str(D)])
    from cartnet_tpu.cli import load_datasets
    from cartnet_tpu.models.factory import create_model as jcreate
    test_recs = load_datasets(jcfg, limit=8)[2]
    state_ns = types.SimpleNamespace(
        params=jax.tree.map(jnp.asarray, params),
        bn_state=jax.tree.map(jnp.asarray, state))
    jrunner.inference(jcfg, state_ns, jcreate(jcfg.model)[1],
                      BatchPipeline(test_recs, 4), str(out_j))
    ours = pickle.loads(out_t.read_bytes())
    ref = pickle.loads(out_j.read_bytes())
    assert ours.keys() == ref.keys()
    assert len(ours["pred"]) == len(ref["pred"]) == len(test_recs)
    for k in ("true", "atoms", "pos", "cell", "temp", "refcode"):
        for a, b in zip(ours[k], ref[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)
    # random weights give predictions from ~1e-1 to ~3e4 in one structure:
    # the f32 error of the large entries is held to 1e-4 of the largest
    for a, b in zip(ours["pred"], ref["pred"]):
        _close(a, b, "f32", "pred")
    for k in ("mae", "iou", "similarity_index"):
        for a, b in zip(ours[k], ref[k]):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4,
                                       err_msg=k)


def test_unported_paths_raise(tmp_path, monkeypatch):
    """The iComformer, which raised here until it was ported, builds,
    serves and trains through the same entry points (its numbers against
    the JAX package: tests/test_torch_port_icomformer*.py); an unknown
    model still raises."""
    monkeypatch.chdir(tmp_path)
    ico = create_model(ModelConfig(name="icomformer", dim_in=D), "cpu")
    assert isinstance(ico, IComformer) and not ico.training
    out = cli.main(["--device", "cpu", "--dataset", "synthetic", "--limit",
                    "4", "--inference", "--cholesky", "--model",
                    "iComformer", "--dim_in", str(D), "--inference_output",
                    str(tmp_path / "x.pkl")])
    assert len(out["pred"]) == 2 and (tmp_path / "x.pkl").exists()
    assert all(np.isfinite(p).all() for p in out["pred"])
    state, test = cli.main(["--device", "cpu", "--dataset", "synthetic",
                            "--limit", "4", "--epochs", "1", "--model",
                            "ICOMFORMER", "--dim_in", str(D)])  # training
    assert isinstance(state.model, IComformer) and state.step == 1
    assert np.isfinite(test["MAE"])
    model = create_model(ModelConfig(name="eComformer", dim_in=D), "cpu")
    assert isinstance(model, EComformer) and not model.training
    model.train()  # the eComformer trains (test_torch_port_comformer_train)
    assert model.training and model.equi.training and model.conv2.training
    with pytest.raises(ValueError, match="not implemented"):
        create_model(ModelConfig(name="nosuchmodel"), "cpu")


def test_ecomformer_forward_runs_without_jax():
    code = (
        "import sys, torch\n"
        "from cartnet_tpu_torch.config import ModelConfig\n"
        "from cartnet_tpu_torch.data.batching import make_batches\n"
        "from cartnet_tpu_torch.data.synthetic import synthetic_dataset\n"
        "from cartnet_tpu_torch.models.factory import create_model\n"
        "b = make_batches(synthetic_dataset(2, mean_atoms=20, adp=True), 2)\n"
        "m = create_model(ModelConfig(name='ecomformer', dim_in=128,\n"
        "                             compute_dtype=torch.bfloat16), 'cpu')\n"
        "with torch.no_grad():\n"
        "    pred, _ = m(b[0].to('cpu'))\n"
        "assert pred.dtype == torch.float32\n"
        "assert bool(torch.isfinite(pred).all())\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ------------------------------------------------------ F4: -0.75 / dist

def test_bf16_rbf_edge_features_bitwise(jax_kernels, batches, weights,
                                        monkeypatch):
    """The eComformer's edge features ``-0.75 / dist``, the RBF head's
    input, are bitwise the JAX package's in a bf16 forward: one rounded
    division (``_inv_len``), where torch's scalar / tensor multiplies by a
    rounded reciprocal and rounds twice (ROADMAP F4). The head's output
    stays within one bf16 ulp: on the CPU, XLA's exp and its softplus
    (logaddexp rounded op by op in bf16) round differently from torch's."""
    tbatch, jbatch = batches
    jcfg, params, state, _ = weights
    model = _model(ecomformer_params_from_jax(
        params, state, ModelConfig(name="ecomformer", dim_in=D)),
        torch.bfloat16)
    seen = {}

    def spy(name, fn, pos):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            seen.setdefault(name, (a[pos], out))
            return out
        return wrapped

    monkeypatch.setattr(cm, "_rbf_head", spy("port", cm._rbf_head, 2))
    monkeypatch.setattr(JC, "_rbf_head_apply",
                        spy("jax", JC._rbf_head_apply, 1))
    jcfg = JModelConfig(name="ecomformer", dim_in=D, cholesky=True,
                        compute_dtype=jnp.bfloat16)
    ref_pred, _, _ = JC.ecomformer_apply(
        params, jax.tree.map(jnp.asarray, state), jbatch, jcfg,
        training=False)
    with torch.no_grad():
        pred, _ = model(tbatch.to("cpu"))
    bits = lambda t: (t.view(torch.int16).numpy() if torch.is_tensor(t)
                      else np.asarray(t).view(np.int16)).astype(np.int32)
    m = tbatch.edge_mask
    for (ours, ref), what in zip(zip(seen["port"], seen["jax"]),
                                 ("efeat", "rbf head")):
        assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        ulps = np.abs(bits(ours) - bits(ref))[m]
        assert ulps.max() <= (0 if what == "efeat" else 1), what
    # the multiply by the reciprocal, which the repair replaced, is not
    efeat = seen["port"][0]
    dist = torch.clamp(torch.tensor(tbatch.cart_dist).to(torch.bfloat16),
                       min=1e-6)
    assert torch.equal(efeat, cm._inv_len(dist))
    assert (bits(-0.75 / dist) != bits(efeat))[m].any()
    _close(_np(pred)[tbatch.non_h_mask], _np(ref_pred)[tbatch.non_h_mask],
           "bf16", "pred")
