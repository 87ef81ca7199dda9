"""The sequence slice's host data and layers against the JAX package:
``SyntheticSequence`` (bit for bit), ``masked_mean_pool`` and the
input-BatchNorm MLP in train and eval mode, running stats included.

Tolerances: ``masked_mean_pool`` computes the same f32 sums, 1e-6 abs. The
MLP computes in bf16 after an f32 BatchNorm: outputs within 1e-2 abs
(bf16 rounding of the hidden layers, as in ``test_torch_layers.py``); the
BatchNorm alone and its running stats are f32 reductions in another order,
1e-6 abs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommender_tpu.data.synthetic import SyntheticSequence as JaxSyntheticSequence
from recommender_tpu.nn.mlp import MLP as JaxMLP
from recommender_tpu.nn.sequence import masked_mean_pool as jax_masked_mean_pool
from recommender_tpu_torch.convert import load_flax_params
from recommender_tpu_torch.data import SyntheticSequence
from recommender_tpu_torch.nn import MLP, BatchNorm, masked_mean_pool


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize(
    "kw,n,seed",
    [
        (dict(num_items=1000, num_cats=50, max_len=20, seed=0), 64, 1),
        (dict(num_items=400_000, num_cats=1500, max_len=100, seed=0), 16, 1),
        (dict(num_items=200, num_cats=5, max_len=8, num_topics=8, seed=3), 40, 9),
    ],
)
def test_synthetic_sequence_bit_identical(kw, n, seed):
    ours = SyntheticSequence(**kw).sample(n, seed)
    ref = JaxSyntheticSequence(**kw).sample(n, seed)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        assert ours[k].tobytes() == ref[k].tobytes(), k


def test_masked_mean_pool_matches_jax():
    rng = np.random.default_rng(0)
    his = rng.normal(size=(5, 7, 6)).astype(np.float32)
    mask = (rng.random((5, 7)) < 0.6).astype(np.float32)
    mask[0] = 0.0  # an all-pad history pools to zeros (count clamped to 1)
    want = np.asarray(jax_masked_mean_pool(jnp.asarray(his), jnp.asarray(mask)))
    got = masked_mean_pool(torch.tensor(his), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got[0].any()


def _bn_mlp(units=(32, 16, 1), d=12):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(64, d)) * 3.0 + 1.5).astype(np.float32)
    jm = JaxMLP(units, final_activation=jax.nn.sigmoid, input_batch_norm=True)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, d)))
    tm = MLP(d, units, final_activation=torch.sigmoid, input_batch_norm=True)
    load_flax_params(tm, _np_tree(variables["params"]), _np_tree(variables["batch_stats"]))
    return jm, variables, tm, x


def test_batchnorm_mlp_train_mode_and_running_stats_match_jax():
    """Train mode: batch statistics, and the running stats moved with
    momentum 0.99 and the biased batch variance — after two steps."""
    jm, variables, tm, x = _bn_mlp()
    tm.train()
    stats = variables["batch_stats"]
    for step in range(2):
        xs = x * (1.0 + step)
        want, upd = jm.apply(
            {"params": variables["params"], "batch_stats": stats}, jnp.asarray(xs),
            train=True, mutable=["batch_stats"],
        )
        stats = upd["batch_stats"]
        got = tm(torch.tensor(xs)).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-2)
    bn = tm.BatchNorm_0
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(stats["BatchNorm_0"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(stats["BatchNorm_0"]["var"]), atol=1e-6)
    # the batch variance is biased: torch's BatchNorm1d would move var elsewhere
    torch_bn = torch.nn.BatchNorm1d(x.shape[1], momentum=0.01)
    torch_bn(torch.tensor(x))
    assert not np.allclose(torch_bn.running_var.numpy(), 0.99 + 0.01 * x.var(0), atol=1e-7)
    np.testing.assert_allclose(
        torch_bn.running_var.numpy(), 0.99 + 0.01 * x.var(0, ddof=1), rtol=1e-5
    )


def test_batchnorm_mlp_eval_mode_uses_running_stats():
    jm, variables, tm, x = _bn_mlp()
    stats = {"BatchNorm_0": {"mean": np.full(12, 0.5, np.float32),
                             "var": np.linspace(0.5, 2.0, 12).astype(np.float32)}}
    load_flax_params(tm, _np_tree(variables["params"]), stats)
    tm.eval()
    want = jm.apply({"params": variables["params"], "batch_stats": stats}, jnp.asarray(x))
    got = tm(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-2)
    np.testing.assert_array_equal(tm.BatchNorm_0.mean.numpy(), stats["BatchNorm_0"]["mean"])


def test_batchnorm_alone_matches_flax_in_f32():
    """The normalization itself, without the bf16 layers: train-mode output
    and its input gradient."""
    import flax.linen as fnn

    rng = np.random.default_rng(2)
    x = (rng.normal(size=(32, 5)) * 2.0 - 1.0).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, dtype=jnp.float32)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def f(x_):
        y, _ = jbn.apply(variables, x_, mutable=["batch_stats"])
        return jnp.sum(y * cot), y

    (_, want), want_dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    bn = BatchNorm(5)
    xt = torch.tensor(x, requires_grad=True)
    y = bn(xt)
    (y * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=0, atol=1e-5)
