"""Plain Adam, Adagrad and SGD (``core.optim.make_optimizer``) against the
JAX Trainer's ``make_optimizer`` (optax), and the ``stochastic_round``
switch resolved as the JAX Trainer resolves it.

Three updates from one init on one gradient stream, each optimizer with and
without ``lr_scales``, over three leaves (two of them bf16 in the bf16
case). Tolerances:
* f32 leaves: 1e-6 abs on values of order 1 (f32 roundoff of the same
  arithmetic);
* bf16 leaves: 2 bf16 ulps of the leaf's magnitude (2^-7 relative), for
  params and state: optax runs the update in bf16 where the port keeps it
  in f32 and rounds once, at the write, so a value near a rounding
  boundary may land one ulp over, and a later step can add another;
* the stochastic-rounding write (every optimizer's, as the JAX Trainer's
  ``_apply``) with JAX's keys: the same 2 ulps, since the f32 value before
  the rounding differs as above.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from recommender_tpu.core.optim import apply_updates_sr as jax_apply_updates_sr
from recommender_tpu.core.optim import has_low_precision_leaf as jax_has_low_precision_leaf
from recommender_tpu.core.train import TrainConfig as JaxTrainConfig
from recommender_tpu.core.train import make_optimizer as jax_make_optimizer
from recommender_tpu_torch.core.optim import (
    SGD,
    Adagrad,
    Adam,
    AdamSR,
    has_low_precision_leaf,
    make_optimizer,
)
from recommender_tpu_torch.core.train import TrainConfig, Trainer

SHAPES = {"a": (64, 16), "b": (32,), "c": (7,)}
LR, STEPS = 1e-2, 3
SCALES = {"a": 0.5, "c": 3.0}


def _words(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def _run(optimizer, dtypes, scales, stochastic=False):
    """Both sides' params and state after STEPS updates."""
    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    dt = dict(zip("abc", dtypes))
    jparams = {k: jnp.asarray(v).astype(jnp.dtype(dt[k])) for k, v in init.items()}
    jcfg = JaxTrainConfig(learning_rate=LR, optimizer=optimizer, lr_scales=scales)
    jopt = jax_make_optimizer(jcfg, stochastic=stochastic)
    jstate = jopt.init(jparams)
    # a copy: jnp.asarray may alias an aligned numpy buffer, which the port's
    # in-place steps would then move under the JAX side
    tparams = [nn.Parameter(torch.tensor(init[k]).to(getattr(torch, dt[k]))) for k in "abc"]
    cfg = TrainConfig(learning_rate=LR, optimizer=optimizer, lr_scales=scales)
    topt = make_optimizer(cfg, list(zip("abc", tparams)), stochastic=stochastic)
    write = jax.random.fold_in(jax.random.PRNGKey(0), 0x5EED)
    for s, g in enumerate(grads):
        jg = {k: jnp.asarray(v).astype(jparams[k].dtype) for k, v in g.items()}
        upd, jstate = jopt.update(jg, jstate, jparams)
        key = jax.random.fold_in(write, s)
        jparams = (jax_apply_updates_sr(jparams, upd, key) if stochastic
                   else optax.apply_updates(jparams, upd))
        for p, k in zip(tparams, "abc"):
            p.grad = torch.from_numpy(g[k]).to(p.dtype)
        topt.step(_words(key))
    return jparams, jstate, tparams, topt


def _close(ours: torch.Tensor, ref, name):
    assert ours.dtype == getattr(torch, str(ref.dtype)), name
    o, r = ours.detach().float().numpy(), np.asarray(jnp.asarray(ref).astype(jnp.float32))
    if ours.dtype == torch.float32:
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-6, err_msg=name)
    else:
        np.testing.assert_allclose(o, r, rtol=0, atol=2.0 ** -7 * np.abs(r).max(), err_msg=name)


# optax state of each base transformation -> the port's slots
_STATE = {"adam": ("mu", "nu"), "adagrad": ("sum_of_squares",), "sgd": ()}
_TYPES = {"adam": Adam, "adagrad": Adagrad, "sgd": SGD}


@pytest.mark.parametrize("scales", [None, SCALES], ids=["plain", "lr_scales"])
@pytest.mark.parametrize("dtypes", [("float32",) * 3, ("bfloat16", "float32", "bfloat16")],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("optimizer", ["adam", "adagrad", "sgd"])
def test_optimizer_matches_optax(optimizer, dtypes, scales):
    jparams, jstate, tparams, topt = _run(optimizer, dtypes, scales)
    assert type(topt) is _TYPES[optimizer] and topt.count == STEPS
    base = jstate[0] if scales else jstate  # optax.chain(base, scale) with lr_scales
    base = base[0] if isinstance(base, tuple) else base  # base = chain(transform, lr)
    for i, (p, k) in enumerate(zip(tparams, "abc")):
        _close(p, jparams[k], k)
        for slot in _STATE[optimizer]:
            _close(topt.state[p][slot], getattr(base, slot)[k], f"{slot}[{k}]")
    assert set(topt.state_dict()) == {"count", *_STATE[optimizer]}


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
def test_stochastic_param_write_applies_to_every_optimizer(optimizer):
    """With stochastic rounding on, Adagrad and SGD write low-precision
    params through ``apply_updates_sr`` with the Trainer's keys, as JAX's
    ``_apply`` does whatever the optimizer."""
    jparams, _, tparams, topt = _run(optimizer, ("bfloat16", "float32", "bfloat16"), None,
                                     stochastic=True)
    assert topt.stochastic
    for p, k in zip(tparams, "abc"):
        _close(p, jparams[k], k)


def test_state_dict_round_trips_and_refuses_another_shape():
    p = nn.Parameter(torch.ones(4))
    opt = Adagrad([p], lr=0.1)
    p.grad = torch.full((4,), 2.0)
    opt.step()
    sd = opt.state_dict()
    other = Adagrad([nn.Parameter(torch.ones(4))], lr=0.1)
    other.load_state_dict(sd)
    assert other.count == 1 and torch.equal(other.state_dict()["sum_of_squares"][0],
                                            sd["sum_of_squares"][0])
    with pytest.raises(ValueError):
        Adagrad([nn.Parameter(torch.ones(5))]).load_state_dict(sd)
    with pytest.raises(ValueError, match="unknown"):
        make_optimizer(TrainConfig(optimizer="unknown"), [("w", p)])


class _Two(nn.Module):
    def __init__(self, table_dtype):
        super().__init__()
        self.table = nn.Parameter(torch.zeros(6, 2, dtype=table_dtype))
        self.w = nn.Parameter(torch.zeros(2))


@pytest.mark.parametrize("optimizer", ["adam", "adagrad", "sgd"])
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stochastic_round", [None, True, False])
def test_stochastic_round_resolves_as_in_jax(optimizer, table_dtype, stochastic_round):
    """None is "the model has a low-precision float param" (JAX's
    ``has_low_precision_leaf``); True and False are taken as they are. SR
    Adam (moment rounding) comes only with "adam"; the stochastic param
    write with any optimizer."""
    jax_params = {"table": jnp.zeros((6, 2), jnp.dtype(table_dtype)), "w": jnp.zeros(2)}
    want = (jax_has_low_precision_leaf(jax_params) if stochastic_round is None
            else stochastic_round)
    model = _Two(getattr(torch, table_dtype))
    assert has_low_precision_leaf(model.parameters()) == (table_dtype == "bfloat16")
    tr = Trainer(lambda b, t: (b, {}), TrainConfig(optimizer=optimizer,
                                                   stochastic_round=stochastic_round),
                 device="cpu")
    state = tr.init_state(lambda: model)
    assert tr.stochastic_round is want
    assert state.optimizer.stochastic is want
    want_type = AdamSR if optimizer == "adam" and want else _TYPES[optimizer]
    assert type(state.optimizer) is want_type


def test_trainer_refuses_an_unknown_optimizer():
    with pytest.raises(ValueError, match="rmsprop"):
        Trainer(lambda b, t: (b, {}), TrainConfig(optimizer="rmsprop"), device="cpu")
