"""The port's eComformer at a narrow width (d = 64) against the JAX
package.

At d = 64 the JAX package runs every edge kernel's XLA path (its Pallas
gates need d % 128 == 0); the port's kernels take the width on the card by
zero-padding (K1, K5, K8 to 128; K7 natively, d % 16 == 0) and on the CPU
run their plain versions, which this test drives. Same weights (JAX
``ecomformer_init`` with randomized eval BN, moved across with
``ecomformer_params_from_jax``) and the same two-crystal batch.

Tolerance: f32 1e-4 of the prediction's largest magnitude (sums in other
orders over three convs and the equivariant block).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cartnet_tpu.config import ModelConfig as JModelConfig
from cartnet_tpu.data.batching import bandwidth_reorder as jreorder
from cartnet_tpu.data.batching import collate as jcollate
from cartnet_tpu.models import comformer as JC
from cartnet_tpu_torch.config import ModelConfig
from cartnet_tpu_torch.data.batching import make_batches
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.interop import ecomformer_params_from_jax
from cartnet_tpu_torch.models.comformer import EComformer

D = 64


def test_forward_at_d64_matches_jax_xla_path():
    recs = synthetic_dataset(2, mean_atoms=48, adp=True, seed=21)
    tbatch = make_batches(recs, 2)[0]
    jbatch = jax.tree.map(jnp.asarray, jcollate(
        [jreorder(r) for r in recs], tbatch.num_nodes, tbatch.num_edges, 2,
        edge_align=512))
    jcfg = JModelConfig(name="ecomformer", dim_in=D, cholesky=True)
    params, state = JC.ecomformer_init(jax.random.key(0), jcfg)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(100)
    for mod, bn in [(f"conv{i}", b) for i in range(3)
                    for b in ("bn", "bn_att")] + [("equi", "bn")]:
        n = params[mod][bn]["gamma"].shape[0]
        params[mod][bn]["gamma"] = (1 + 0.1 * rng.normal(size=n)).astype(
            np.float32)
        params[mod][bn]["beta"] = (0.1 * rng.normal(size=n)).astype(
            np.float32)
        state[mod][bn]["mean"] = (0.2 * rng.normal(size=n)).astype(
            np.float32)
        state[mod][bn]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    ref_pred, ref_mask, _ = JC.ecomformer_apply(
        params, jax.tree.map(jnp.asarray, state), jbatch, jcfg,
        training=False)
    cfg = ModelConfig(name="ecomformer", dim_in=D)
    model = EComformer(cfg, device="cpu", seed=9)
    model.load_state_dict(ecomformer_params_from_jax(params, state, cfg),
                          strict=True)
    with torch.no_grad():
        pred, mask = model(tbatch.to("cpu"))
    assert pred.dtype == torch.float32 and pred.shape == (tbatch.num_nodes,
                                                          3, 3)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    m = tbatch.non_h_mask
    a = pred.numpy()[m]
    b = np.asarray(ref_pred, dtype=np.float32)[m]
    assert np.isfinite(a).all()
    err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    assert err <= 1e-4, err
