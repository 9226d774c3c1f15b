"""Port nn/ops/metrics vs the JAX package on the same numpy inputs.

Tolerance: f32 atol = rtol = 1e-5 (the two frameworks sum and evaluate
transcendentals in different orders); exact where the operation is a copy.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartnet_tpu.nn import core as jcore
from cartnet_tpu.nn import norm as jnorm
from cartnet_tpu.ops import linalg3 as jla
from cartnet_tpu.ops import rbf as jrbf
from cartnet_tpu.ops import segment as jseg
from cartnet_tpu.train import metrics as jmet
from cartnet_tpu_torch.nn import core as tcore
from cartnet_tpu_torch.nn import norm as tnorm
from cartnet_tpu_torch.ops import linalg3 as tla
from cartnet_tpu_torch.ops import rbf as trbf
from cartnet_tpu_torch.ops import segment as tseg
from cartnet_tpu_torch.train import metrics as tmet

TOL = dict(atol=1e-5, rtol=1e-5)
RNG = np.random.default_rng(0)


def _close(ours, ref, **tol):
    ours = ours.detach().float().numpy() if torch.is_tensor(ours) else ours
    np.testing.assert_allclose(ours, np.asarray(ref, np.float32),
                               **(tol or TOL))


def _spd(n):
    m = RNG.normal(size=(n, 3, 3)).astype(np.float32) * 0.1
    return (np.einsum("nij,nkj->nik", m, m)
            + 0.01 * np.eye(3, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("wdtype", ["f32", "bf16"])
def test_linear_and_mlp_silu(wdtype):
    x = RNG.normal(size=(37, 24)).astype(np.float32)
    w0 = RNG.normal(size=(24, 16)).astype(np.float32) * 0.2
    b0 = RNG.normal(size=16).astype(np.float32)
    w1 = RNG.normal(size=(16, 8)).astype(np.float32) * 0.2
    b1 = RNG.normal(size=8).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if wdtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jp = {"lin0": {"w": jnp.asarray(w0, jdt), "b": jnp.asarray(b0, jdt)},
          "lin1": {"w": jnp.asarray(w1, jdt), "b": jnp.asarray(b1, jdt)}}
    tw = lambda w: torch.tensor(w.T.copy()).to(tdt)
    tb = lambda b: torch.tensor(b).to(tdt)
    # f32 activations against f32 or bf16 weights: the product promotes
    y_ref = jcore.linear(jp["lin0"], jnp.asarray(x))
    y = tcore.linear(torch.tensor(x), tw(w0), tb(b0))
    assert y.dtype == torch.float32 and y_ref.dtype == jnp.float32
    _close(y, y_ref)
    for final in (False, True):
        ref = jcore.mlp_silu(jp, jnp.asarray(x), 2, final_act=final)
        ours = tcore.mlp_silu(torch.tensor(x),
                              [(tw(w0), tb(b0)), (tw(w1), tb(b1))],
                              final_act=final)
        _close(ours, ref)


def test_bf16_linear_rounds_like_reference():
    x = RNG.normal(size=(64, 32)).astype(np.float32)
    w = RNG.normal(size=(32, 16)).astype(np.float32) * 0.2
    b = RNG.normal(size=16).astype(np.float32)
    ref = jcore.linear({"w": jnp.asarray(w, jnp.bfloat16),
                        "b": jnp.asarray(b, jnp.bfloat16)},
                       jnp.asarray(x, jnp.bfloat16))
    ours = tcore.linear(torch.tensor(x).bfloat16(),
                        torch.tensor(w.T.copy()).bfloat16(),
                        torch.tensor(b).bfloat16())
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    # bf16 outputs: one bf16 rounding of an f32-accumulated product, 2^-8
    _close(ours, np.asarray(ref, np.float32), atol=1e-2, rtol=2 ** -7)


def test_torch_linear_init_bounds():
    lin = torch.nn.Linear(50, 40)
    tcore.torch_linear_init_(lin, torch.Generator().manual_seed(0))
    bound = 1.0 / math.sqrt(50)
    for t in (lin.weight.detach(), lin.bias.detach()):
        assert float(t.abs().max()) <= bound
        assert float(t.abs().max()) > 0.9 * bound  # fills the range
    a = torch.nn.Linear(50, 40)
    tcore.torch_linear_init_(a, torch.Generator().manual_seed(0))
    assert torch.equal(a.weight, lin.weight)  # seeded -> reproducible
    emb = torch.empty(119, 64)
    tcore.xavier_uniform_(emb, torch.Generator().manual_seed(1))
    assert float(emb.abs().max()) <= math.sqrt(6.0 / (119 + 64))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embeddings_are_exact_copies(dtype):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    table = RNG.normal(size=(119, 16)).astype(np.float32)
    z = RNG.integers(0, 119, 50).astype(np.int32)
    ref = jcore.embedding_onehot({"w": jnp.asarray(table)}, jnp.asarray(z),
                                 jdt)
    ours = tcore.embedding(torch.tensor(table), torch.tensor(z), tdt)
    assert ours.dtype == tdt
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(ref, np.float32))
    rows = RNG.normal(size=(5, 16)).astype(np.float32)
    gid = RNG.integers(0, 5, 50).astype(np.int32)
    ref = jcore.gather_rows_onehot(jnp.asarray(rows), jnp.asarray(gid), 5,
                                   jdt)
    ours = tcore.embedding(torch.tensor(rows), torch.tensor(gid), tdt)
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("xdtype", ["f32", "bf16"])
def test_eval_batch_norm(xdtype):
    d = 12
    x = RNG.normal(size=(40, d)).astype(np.float32) * 3 + 1
    mask = RNG.random(40) > 0.3
    gamma = RNG.normal(size=d).astype(np.float32)
    beta = RNG.normal(size=d).astype(np.float32)
    mean = RNG.normal(size=d).astype(np.float32)
    var = RNG.uniform(0.2, 3.0, d).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if xdtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    params = {"gamma": jnp.asarray(gamma, jdt), "beta": jnp.asarray(beta, jdt)}
    state = {"mean": jnp.asarray(mean), "var": jnp.asarray(var),
             "count": jnp.zeros((), jnp.int32)}
    T = lambda a: torch.tensor(a)
    y_ref, _ = jnorm.masked_batch_norm(params, state, jnp.asarray(x, jdt),
                                       jnp.asarray(mask), training=False)
    y = tnorm.masked_batch_norm(T(x).to(tdt), T(gamma).to(tdt),
                                T(beta).to(tdt), T(mean), T(var))
    # f32 running stats promote a bf16 input to f32, in both packages
    assert y.dtype == torch.float32 and y_ref.dtype == jnp.float32
    _close(y, y_ref)
    s_ref, sh_ref, _ = jnorm.masked_bn_scale_shift(
        params, state, jnp.asarray(x, jdt), jnp.asarray(mask), training=False)
    s, sh = tnorm.masked_bn_scale_shift(T(gamma).to(tdt), T(beta).to(tdt),
                                        T(mean), T(var))
    _close(s, s_ref)
    _close(sh, sh_ref)


def test_rbf_and_cutoff():
    dist = RNG.uniform(0.5, 6.0, 200).astype(np.float32)
    _close(trbf.cosine_cutoff(torch.tensor(dist), 5.0),
           jrbf.cosine_cutoff(jnp.asarray(dist), 5.0))
    _close(trbf.cosine_cutoff(torch.tensor(dist), 5.0, 1.0),
           jrbf.cosine_cutoff(jnp.asarray(dist), 5.0, 1.0))
    m_ref, b_ref = jrbf.exp_normal_params(0.0, 5.0, 16)
    m, b = trbf.exp_normal_params(0.0, 5.0, 16)
    _close(m, m_ref, atol=1e-7, rtol=1e-6)
    _close(b, b_ref)
    _close(trbf.exp_normal_smearing(torch.tensor(dist), m, b, 5.0),
           jrbf.exp_normal_smearing(jnp.asarray(dist), m_ref, b_ref, 5.0))


def test_linalg3():
    a = _spd(30)
    T = torch.tensor
    _close(tla.det3(T(a)), jla.det3(jnp.asarray(a)), atol=1e-9, rtol=1e-5)
    _close(tla.inv3(T(a)), jla.inv3(jnp.asarray(a)), atol=1e-3, rtol=1e-5)
    _close(tla.frobenius3(T(a)), jla.frobenius3(jnp.asarray(a)))
    diag = RNG.uniform(0.1, 1.0, (30, 3)).astype(np.float32)
    off = RNG.normal(size=(30, 3)).astype(np.float32)
    _close(tla.assemble_cholesky_upper(T(diag), T(off)),
           jla.assemble_cholesky_upper(jnp.asarray(diag), jnp.asarray(off)))


def test_masked_segment_sum():
    vals = RNG.normal(size=(60, 8)).astype(np.float32)
    ids = np.sort(RNG.integers(0, 10, 60)).astype(np.int32)
    mask = RNG.random(60) > 0.25
    T = torch.tensor
    _close(tseg.segment_sum(T(vals), T(ids), 10),
           jseg.segment_sum(jnp.asarray(vals), jnp.asarray(ids), 10))
    _close(tseg.masked_segment_sum(T(vals), T(ids), T(mask), 10),
           jseg.masked_segment_sum(jnp.asarray(vals), jnp.asarray(ids),
                                   jnp.asarray(mask), 10))


def test_metrics():
    p, t = _spd(40), _spd(40)
    mask = RNG.random(40) > 0.3
    T = torch.tensor
    mae, mse = tmet.masked_mae_mse(T(p), T(t), T(mask))
    mae_r, mse_r = jmet.masked_mae_mse(jnp.asarray(p), jnp.asarray(t),
                                       jnp.asarray(mask))
    _close(mae, mae_r)
    _close(mse, mse_r)
    _close(tmet.get_similarity_index(T(p), T(t)),
           jmet.get_similarity_index(jnp.asarray(p), jnp.asarray(t)),
           atol=1e-4, rtol=1e-5)
    iou = tmet.compute_3d_iou(T(p[:12]), T(t[:12]))
    iou_r = jmet.compute_3d_iou(jnp.asarray(p[:12]), jnp.asarray(t[:12]))
    _close(iou, iou_r)
