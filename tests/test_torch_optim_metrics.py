"""SR-Adam and the streaming metrics against the JAX package.

* f32 params: ``AdamSR`` is plain Adam; it matches JAX ``adam_sr`` and
  ``optax.adam`` to f32 roundoff (≤ 1e-6 abs on values of order 1).
* bf16 params and moments: the rounding keys and noise are reproduced word
  for word and the f32 arithmetic before each rounding is the same, so the
  written bf16 values equal JAX's bit for bit.
* metrics: histogram AUC, mean and accuracy ≤ 1e-6; ``exact_auc`` is the
  same numpy code (equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommender_tpu.core import metrics as jax_metrics
from recommender_tpu.core.optim import adam_sr as jax_adam_sr
from recommender_tpu.core.optim import apply_updates_sr as jax_apply_updates_sr
from recommender_tpu_torch.core import metrics
from recommender_tpu_torch.core.optim import AdamSR


def _words(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def _tree(rng, dtypes):
    """{"a": [64,16], "b": [32], "c": [7]} in the given dtypes (JAX flatten
    order a, b, c = the port's leaf order)."""
    shapes = {"a": (64, 16), "b": (32,), "c": (7,)}
    return {k: rng.normal(size=shapes[k]).astype(np.float32) for k in shapes}, dict(zip("abc", dtypes))


def _run_both(dtypes, steps, lr=1e-2, seed=0):
    rng = np.random.default_rng(0)
    init, dt = _tree(rng, dtypes)
    grads = [
        {k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()}
        for _ in range(steps)
    ]
    jparams = {k: jnp.asarray(v).astype(jnp.dtype(dt[k])) for k, v in init.items()}
    opt = jax_adam_sr(lr, seed=seed)
    jstate = opt.init(jparams)
    tparams = [  # copies: jnp.asarray may alias an aligned numpy buffer
        torch.nn.Parameter(torch.tensor(init[k]).to(getattr(torch, dt[k])))
        for k in "abc"
    ]
    topt = AdamSR(tparams, lr=lr, seed=seed)
    write = jax.random.fold_in(jax.random.PRNGKey(seed), 0x5EED)
    for s, g in enumerate(grads):
        jg = {k: jnp.asarray(v).astype(jparams[k].dtype) for k, v in g.items()}
        upd, jstate = opt.update(jg, jstate, jparams)
        key = jax.random.fold_in(write, s)
        jparams = jax_apply_updates_sr(jparams, upd, key)
        for p, k in zip(tparams, "abc"):
            p.grad = torch.from_numpy(g[k]).to(p.dtype)
        topt.step(_words(key))
    return jparams, jstate, tparams, topt


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_adam_sr_f32_matches_jax_and_optax():
    jparams, _, tparams, topt = _run_both(("float32",) * 3, steps=5)
    for p, k in zip(tparams, "abc"):
        np.testing.assert_allclose(p.detach().numpy(), _f32(jparams[k]), rtol=0, atol=1e-6)
    # and plain optax.adam on the same stream
    rng = np.random.default_rng(0)
    init, _ = _tree(rng, ("float32",) * 3)
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()} for _ in range(5)]
    ref = {k: jnp.asarray(v) for k, v in init.items()}
    adam = optax.adam(1e-2)
    st = adam.init(ref)
    for g in grads:
        u, st = adam.update({k: jnp.asarray(v) for k, v in g.items()}, st, ref)
        ref = optax.apply_updates(ref, u)
    for p, k in zip(tparams, "abc"):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref[k]), rtol=0, atol=1e-6)


def test_adam_sr_bf16_writes_match_jax():
    jparams, jstate, tparams, topt = _run_both(("bfloat16", "float32", "bfloat16"), steps=4)
    adam_state = jstate[0]
    for p, k in zip(tparams, "abc"):
        pairs = [
            (p.detach(), jparams[k]),
            (topt.state[p]["mu"], adam_state.mu[k]),
            (topt.state[p]["nu"], adam_state.nu[k]),
        ]
        for ours, ref in pairs:
            assert ours.dtype == getattr(torch, str(ref.dtype))
            o, r = ours.float().numpy(), _f32(ref)
            if ours.dtype == torch.float32:
                np.testing.assert_allclose(o, r, rtol=0, atol=1e-6)
                continue
            np.testing.assert_array_equal(o, r, err_msg=k)


def test_adam_sr_moment_dtype_float32():
    p = torch.nn.Parameter(torch.ones(8, dtype=torch.bfloat16))
    opt = AdamSR([p], moment_dtype=torch.float32)
    p.grad = torch.full((8,), 0.5, dtype=torch.bfloat16)
    opt.step((0, 1))
    assert opt.state[p]["mu"].dtype == torch.float32 and p.dtype == torch.bfloat16
    assert opt.count == 1


def _scores_labels(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.3).astype(np.float32)
    scores = np.clip(0.3 * labels + rng.random(n) * 0.7, 0, 1).astype(np.float32)
    scores[:10] = [0.0, 1.0, 0.5, 0.5, 0.25, 0.25, 0.999999, 1e-9, 0.75, 0.75]
    return scores, labels


def test_histogram_auc_mean_accuracy_match_jax():
    s, y = _scores_labels()
    w = np.random.default_rng(1).random(s.size).astype(np.float32)
    js = jax_metrics.auc_update(jax_metrics.AUCState.init(), jnp.asarray(s), jnp.asarray(y))
    js = jax_metrics.auc_update(js, jnp.asarray(s[:700]), jnp.asarray(y[:700]), jnp.asarray(w[:700]))
    ts = metrics.auc_update(metrics.AUCState.init(), torch.from_numpy(s), torch.from_numpy(y))
    ts = metrics.auc_update(ts, torch.from_numpy(s[:700]), torch.from_numpy(y[:700]), torch.from_numpy(w[:700]))
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.neg.numpy(), np.asarray(js.neg), rtol=1e-6, atol=1e-6)
    a_t = float(metrics.auc_from_state(ts))
    a_j = float(jax_metrics.auc_from_state(js))
    assert abs(a_t - a_j) < 1e-6
    m_t = metrics.accuracy_update(metrics.MeanState.init(), torch.from_numpy(s), torch.from_numpy(y))
    m_t = metrics.mean_update(m_t, torch.from_numpy(w))
    m_j = jax_metrics.accuracy_update(jax_metrics.MeanState.init(), jnp.asarray(s), jnp.asarray(y))
    m_j = jax_metrics.mean_update(m_j, jnp.asarray(w))
    assert abs(float(metrics.mean_from_state(m_t)) - float(jax_metrics.mean_from_state(m_j))) < 1e-6
    merged = ts.merge(ts)
    assert abs(float(metrics.auc_from_state(merged)) - a_t) < 1e-6


@pytest.mark.parametrize("weighted", [False, True])
def test_exact_auc_matches_jax(weighted):
    s, y = _scores_labels(seed=3)
    w = np.random.default_rng(4).random(s.size) if weighted else None
    assert metrics.exact_auc(s, y, w) == jax_metrics.exact_auc(s, y, w)
    assert metrics.exact_auc(s, np.ones_like(y)) == 0.5  # one class only


def test_streaming_auc_matches_jax():
    s, y = _scores_labels(seed=5)
    ours, ref = metrics.StreamingAUC(), jax_metrics.StreamingAUC()
    for lo in range(0, s.size, 1000):
        ours.update_state(y[lo : lo + 1000], s[lo : lo + 1000])
        ref.update_state(y[lo : lo + 1000], s[lo : lo + 1000])
    assert abs(ours.result() - ref.result()) < 1e-6
    ours.reset_state()
    assert ours.result() == 0.0
