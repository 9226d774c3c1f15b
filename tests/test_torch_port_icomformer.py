"""The port's iComformer eval forward and its modules vs the JAX package.

Same batch as tests/test_torch_port_comformer.py (two crystals of ~48
atoms, per-graph edge alignment 512) and the same weights on both sides:
JAX ``icomformer_init`` with randomized BN affine parameters and BN running
stats of a model that has seen the batch (one f32 train-mode JAX forward
with momentum 1, then perturbed per channel), moved across with
``icomformer_params_from_jax``. Stats that do not describe the activations
(the eComformer tests' N(0.2) means and U(0.5, 2) variances) let the four
convs grow the activations to ~2e3 and make the bf16 forward chaotic: one
ulp flipped in 1% of the edge features' bf16 entries then moves the port's
own bf16 prediction by ~9% (on the CPU), so a comparison of two bf16
implementations would measure that, not the port. The JAX side runs K1 and K2 in
interpret mode (``_FORCE_SIGMA_INTERPRET``); its K3 call site is not on
the eval path.

Tolerances: f32 1e-4 normalized; bf16 3e-2 of the tensor's largest
magnitude; dtypes equal. Compared: the lattice features, the eval edge
update, the whole forward at d = 128 and 64, rotation invariance, the CLI
sweep against ``cartnet_tpu.runner.inference``, and the conv's weight cast
(the eComformer's forward bitwise as without it).
"""

import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartnet_tpu import runner as jrunner
from cartnet_tpu.config import Config as JConfig
from cartnet_tpu.config import DataConfig as JDataConfig
from cartnet_tpu.config import ModelConfig as JModelConfig
from cartnet_tpu.data.batching import bandwidth_reorder as jreorder
from cartnet_tpu.data.batching import collate as jcollate
from cartnet_tpu.data.pipeline import BatchPipeline
from cartnet_tpu.models import cartnet as jcartnet
from cartnet_tpu.models import comformer as JC
from cartnet_tpu.nn import core as jcore
from cartnet_tpu_torch import cli
from cartnet_tpu_torch.config import ModelConfig
from cartnet_tpu_torch.data.batching import collate, make_batches
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.interop import icomformer_params_from_jax
from cartnet_tpu_torch.models import comformer as cm
from cartnet_tpu_torch.models.comformer import (EComformer, IComformer,
                                                lattice_features)
from cartnet_tpu_torch.models.factory import create_model
from cartnet_tpu_torch.nn.core import Params, cast_params

D = 128
BNS = [(f"conv{i}", bn) for i in range(4) for bn in ("bn", "bn_att")] + [
    ("edge_update", "bn"), ("edge_update", "bn_att")]


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
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


def _jax_weights(jbatch, d=D, seed=0, use_temperature=True):
    """icomformer_init with random BN affine parameters and the running
    stats of one f32 train forward over ``jbatch`` (momentum 1), each
    channel's mean moved by 0.1 of its std and its variance scaled by
    U(0.8, 1.25); with ``jbatch`` None, the eComformer tests' random
    stats."""
    jcfg = JModelConfig(name="icomformer", dim_in=d, cholesky=True,
                        use_temperature=use_temperature)
    params, state = JC.icomformer_init(jax.random.key(seed), jcfg)
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed + 100)
    for mod, bn in BNS:
        n = params[mod][bn]["gamma"].shape[0]
        params[mod][bn]["gamma"] = (1.0 + 0.1 * rng.normal(size=n)).astype(
            np.float32)
        params[mod][bn]["beta"] = (0.1 * rng.normal(size=n)).astype(
            np.float32)
    if jbatch is None:
        state = jax.tree.map(np.asarray, state)
        for mod, bn in BNS:
            n = state[mod][bn]["mean"].shape[0]
            state[mod][bn]["mean"] = (0.2 * rng.normal(size=n)).astype(
                np.float32)
            state[mod][bn]["var"] = rng.uniform(0.5, 2.0, n).astype(
                np.float32)
        return params, state
    calib = JModelConfig(name="icomformer", dim_in=d, cholesky=True,
                         bn_momentum=1.0)
    _, _, state = JC.icomformer_apply(params, state, jbatch, calib,
                                      training=True)
    state = jax.tree.map(np.asarray, state)
    for mod, bn in BNS:
        s = state[mod][bn]
        n = s["mean"].shape[0]
        s["mean"] = (s["mean"] + 0.1 * np.sqrt(s["var"])
                     * rng.normal(size=n)).astype(np.float32)
        s["var"] = (s["var"] * rng.uniform(0.8, 1.25, n)).astype(np.float32)
    return params, state


@pytest.fixture(scope="module")
def jax_kernels():
    """The JAX package's K1/K2 in interpret mode on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcartnet, "_FORCE_SIGMA_INTERPRET", True)
        yield


def _batch_pair(recs, max_graphs=2):
    tbatch = make_batches(recs, max_graphs)[0]
    jbatch = jcollate([jreorder(r) for r in recs], tbatch.num_nodes,
                      tbatch.num_edges, max_graphs, edge_align=512)
    return tbatch, jax.tree.map(jnp.asarray, jbatch)


@pytest.fixture(scope="module")
def batches():
    recs = synthetic_dataset(2, mean_atoms=48, adp=True, seed=21)
    tbatch, jbatch = _batch_pair(recs)
    assert (~tbatch.edge_mask[:np.flatnonzero(tbatch.edge_mask)[-1]]).any()
    assert jbatch.edge_fuse_ok and jbatch.pallas_seg_ok
    return tbatch, jbatch


def _model(sd, tdt, d=D):
    model = IComformer(ModelConfig(name="icomformer", dim_in=d,
                                   compute_dtype=tdt), device="cpu", seed=9)
    model.load_state_dict(sd, strict=True)
    return model


@pytest.fixture(scope="module")
def weights(batches):
    params, state = _jax_weights(batches[1])
    sd = icomformer_params_from_jax(params, state,
                                    ModelConfig(name="icomformer", dim_in=D))
    return params, state, sd


def _cast(params, jdt):
    return jcore.cast_params(jax.tree.map(jnp.asarray, params), jdt,
                             jnp.float32)


# ------------------------------------------------------- lattice features

def _jax_lattice(jbatch, dt):
    """icomformer_apply's lattice features (cartnet_tpu/models/
    comformer.py:383-433, the non-halo branch), line by line."""
    G, N = jbatch.num_graphs, jbatch.num_nodes
    cell = jbatch.cell.astype(dt)
    row_norm_g = jnp.linalg.norm(cell, axis=-1)
    narange = jnp.arange(N, dtype=jnp.int32)
    garange = jnp.arange(G, dtype=jnp.int32)
    starts = jnp.min(jnp.where((jbatch.graph_id[:, None] == garange[None, :])
                               & jbatch.node_mask[:, None], narange[:, None],
                               N), axis=0)
    gid_e = jnp.clip(jnp.searchsorted(starts, jbatch.edge_dst, side="right")
                     - 1, 0, G - 1).astype(jnp.int32)
    oh_g = (gid_e[:, None] == garange[None, :]).astype(dt)
    row_norm = jnp.dot(oh_g, row_norm_g, preferred_element_type=dt)
    nei_len_feat = -0.75 / jnp.maximum(row_norm, 1e-6)
    dirs = jbatch.cart_dir.astype(dt)
    cos_all = jnp.dot(dirs, cell.reshape(G * 3, 3).T,
                      preferred_element_type=dt)
    cos_raw = jnp.einsum("eg,egr->er", oh_g, cos_all.reshape(-1, G, 3))
    cosang = cos_raw / (
        jnp.maximum(row_norm, 1e-6)
        * jnp.maximum(jnp.linalg.norm(dirs, axis=-1, keepdims=True), 1e-6))
    return nei_len_feat, jnp.clip(cosang, -1.0, 1.0)


@pytest.mark.parametrize("max_graphs", [2, 4])
def test_lattice_features_match_jax(max_graphs):
    """f32 to rounding (1e-6 elementwise, relative; the norms and the
    3-term products sum in other orders) on every edge, pads included;
    with max_graphs 4 the batch holds two empty trailing graphs, and the
    pad edges after the last crystal's edges map past its node range:
    the clamp keeps them on a real graph (finite features)."""
    recs = synthetic_dataset(2, mean_atoms=48, adp=True, seed=21)
    nodes = sum(len(r["z"]) for r in recs)
    edges = sum(len(r["edge_src"]) for r in recs)
    tb = collate(recs, nodes + 16, edges + 300, max_graphs)
    jb = jax.tree.map(jnp.asarray, jcollate(recs, nodes + 16, edges + 300,
                                            max_graphs))
    assert (~tb.edge_mask).any() and (~tb.node_mask).any()
    ref_len, ref_cos = _jax_lattice(jb, jnp.float32)
    nei_len, cosang = lattice_features(tb.to("cpu"), torch.float32)
    assert nei_len.dtype == cosang.dtype == torch.float32
    assert nei_len.shape == cosang.shape == (tb.num_edges, 3)
    assert np.isfinite(_np(nei_len)).all() and np.isfinite(_np(cosang)).all()
    np.testing.assert_allclose(_np(nei_len), _np(ref_len), rtol=1e-6)
    np.testing.assert_allclose(_np(cosang), _np(ref_cos), rtol=1e-6,
                               atol=1e-7)
    assert _np(nei_len).min() > -10.0  # no pad edge on a zero row norm


def test_lattice_features_bf16_match_jax(batches):
    tbatch, jbatch = batches
    ref_len, ref_cos = _jax_lattice(jbatch, jnp.bfloat16)
    nei_len, cosang = lattice_features(tbatch.to("cpu"), torch.bfloat16)
    _same_dtype(nei_len, ref_len)
    _same_dtype(cosang, ref_cos)
    _close(nei_len, ref_len, "bf16", "nei_len")
    _close(cosang, ref_cos, "bf16", "cosang")


# ---------------------------------------------------------- edge update

def _edge_inputs(E, dt, seed):
    rng = np.random.default_rng(seed)
    vals = [np.abs(rng.normal(size=shape)).astype(np.float32)
            for shape in ((E, D), (3 * E, D), (3 * E, D))]
    js = [jnp.asarray(v, dt) for v in vals]
    return js, [torch.tensor(_np(j)).to(_dt(
        "bf16" if dt == jnp.bfloat16 else "f32")[1]) for j in js]


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_edge_update_matches_jax(batches, weights, case):
    """The eval edge update on the same channel-major inputs; in bf16 its
    output is f32 (eval BN's f32 running stats), as in the JAX package."""
    jdt, tdt = _dt(case)
    tbatch, jbatch = batches
    params, state, sd = weights
    (je, jl, ja), (te, tl, ta) = _edge_inputs(tbatch.num_edges, jdt, 1)
    jcfg = JModelConfig(name="icomformer", dim_in=D, compute_dtype=jdt)
    ref, _ = JC.conv_edge_apply(_cast(params, jdt)["edge_update"],
                                jax.tree.map(jnp.asarray,
                                             state["edge_update"]),
                                je, jl, ja, jbatch.edge_mask, jcfg, False)
    model = _model(sd, tdt)
    p = Params(cast_params(model, tdt, torch.float32))
    with torch.no_grad():
        ours = model.edge_update(te, tl, ta, tbatch.to("cpu").edge_mask,
                                 p.sub("edge_update"))
    _same_dtype(ours, ref)
    assert ours.dtype == torch.float32
    _close(ours, ref, case, "edge_update")


# -------------------------------------------------------- whole forward

@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_forward_matches_jax(jax_kernels, batches, weights, case):
    jdt, tdt = _dt(case)
    tbatch, jbatch = batches
    params, state, sd = weights
    jcfg = JModelConfig(name="icomformer", dim_in=D, cholesky=True,
                        compute_dtype=jdt)
    ref_pred, ref_mask, _ = JC.icomformer_apply(
        params, jax.tree.map(jnp.asarray, state), jbatch, jcfg,
        training=False)
    with torch.no_grad():
        pred, mask = _model(sd, tdt)(tbatch.to("cpu"))
    assert pred.dtype == torch.float32 and ref_pred.dtype == jnp.float32
    assert pred.shape == (tbatch.num_nodes, 3, 3)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    m = tbatch.non_h_mask
    _close(_np(pred)[m], _np(ref_pred)[m], case, "pred")


def test_forward_at_d64_matches_jax_xla_path():
    """d = 64: the JAX package's XLA paths (its Pallas gates need d % 128
    == 0), the port's plain versions; f32, 1e-4."""
    recs = synthetic_dataset(2, mean_atoms=48, adp=True, seed=21)
    tbatch, jbatch = _batch_pair(recs)
    params, state = _jax_weights(jbatch, d=64)
    cfg = ModelConfig(name="icomformer", dim_in=64)
    jcfg = JModelConfig(name="icomformer", dim_in=64, cholesky=True)
    ref_pred, _, _ = JC.icomformer_apply(
        params, jax.tree.map(jnp.asarray, state), jbatch, jcfg,
        training=False)
    model = _model(icomformer_params_from_jax(params, state, cfg),
                   torch.float32, d=64)
    with torch.no_grad():
        pred, _ = model(tbatch.to("cpu"))
    m = tbatch.non_h_mask
    assert np.isfinite(_np(pred)[m]).all()
    _close(_np(pred)[m], _np(ref_pred)[m], "f32", "pred d=64")


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return (q if np.linalg.det(q) > 0 else -q).astype(np.float32)


def test_prediction_is_rotation_invariant(batches):
    """Row norms and row-direction cosines are invariant: rotating cell and
    cart_dir together leaves the prediction unchanged."""
    tbatch, _ = batches
    model = IComformer(ModelConfig(name="icomformer", dim_in=D), "cpu",
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
    from cartnet_tpu.cli import load_datasets
    from cartnet_tpu.models.factory import create_model as jcreate
    jcfg = JConfig(model=JModelConfig(name="icomformer", dim_in=D,
                                      use_temperature=False, cholesky=True),
                   data=JDataConfig(name="synthetic"))
    test_recs = load_datasets(jcfg, limit=8)[2]
    params, state = _jax_weights(None, seed=5, use_temperature=False)
    # a head whose ellipsoids are not flat: the random head predicts ADPs
    # of rank ~2 (one eigenvalue ~1e-7 of the largest), whose voxel IoU
    # flips between ~0 and 1 on the last bit of the prediction in either
    # package; its last layer scaled down and the diagonal's biases raised
    last = params["head"]["mlp"]["lin1"]
    last["w"] = last["w"] * np.float32(1e-3)
    last["b"] = last["b"] + np.float32(3.0) * (np.arange(6) < 3)
    ckpt = tmp_path / "icomformer.pt"
    torch.save(icomformer_params_from_jax(
        params, state, ModelConfig(name="icomformer", dim_in=D)), ckpt)
    out_t, out_j = tmp_path / "port.pkl", tmp_path / "jax.pkl"
    cli.main(["--device", "cpu", "--dataset", "synthetic", "--cholesky",
              "--limit", "8", "--inference", "--model", "iComformer",
              "--inference_output", str(out_t), "--checkpoint_path",
              str(ckpt), "--dim_in", str(D)])
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
    for a, b in zip(ours["pred"], ref["pred"]):
        _close(a, b, "f32", "pred")
    for k in ("mae", "iou", "similarity_index"):
        for a, b in zip(ours[k], ref[k]):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4,
                                       err_msg=k)


# ------------------------------------------------------ conv weight cast

def test_conv_weight_cast(batches, weights, monkeypatch):
    """``_as_edge_dtype`` casts K1's bf16 weights to the f32 edges of the
    iComformer's bf16 eval conv1-conv3 and nothing else: without it the
    eComformer's bf16 eval forward is bitwise the same, and the
    iComformer's stops at K1's dtype check."""
    tbatch, _ = batches
    tb = tbatch.to("cpu")
    eco = create_model(ModelConfig(name="ecomformer", dim_in=D,
                                   compute_dtype=torch.bfloat16), "cpu",
                       seed=4)
    ico = _model(weights[2], torch.bfloat16)
    seen = []
    kernel = cm.edge_phase_fwd

    def spy(xi, xj, e, we, *rest, **kw):
        seen.append((xi.dtype, e.dtype, we.dtype))
        return kernel(xi, xj, e, we, *rest, **kw)

    monkeypatch.setattr(cm, "edge_phase_fwd", spy)
    with torch.no_grad():
        pe, _ = eco(tb)
        ico(tb)
        bf, f32 = torch.bfloat16, torch.float32
        assert seen == [(bf, bf, bf)] + [(f32, bf, bf)] * 2 + [
            (bf, bf, bf)] + [(f32, f32, f32)] * 3
        monkeypatch.setattr(cm, "_as_edge_dtype", lambda w, dt: w)
        pe2, _ = eco(tb)
        assert torch.equal(pe, pe2)
        with pytest.raises(TypeError, match="weights share e's"):
            ico(tb)
    assert isinstance(eco, EComformer)
