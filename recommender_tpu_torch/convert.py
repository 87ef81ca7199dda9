"""JAX param tree → the port's ``state_dict``.

The input is a flax param tree as a nested dict of numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``); no jax is needed here. Names map
one to one because the port's modules carry the flax names:

* ``bottom_mlp/Dense_0/kernel`` [in, out] → ``bottom_mlp.Dense_0.weight``
  [out, in] (transposed, the layout of ``torch.nn.Linear``);
* ``…/bias`` → ``….bias`` as is;
* ``embedding/embedding`` [V, D] → ``embedding.embedding`` as is.

bf16 arrays (numpy's ``bfloat16`` extension dtype) keep their bits.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def flax_to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """Flatten a flax param tree into ``state_dict`` entries (CPU tensors)."""
    out: dict[str, torch.Tensor] = {}

    def walk(tree: dict, path: tuple):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
                continue
            arr = np.asarray(value)
            if key == "kernel":
                if arr.ndim != 2:
                    raise ValueError(f"{'/'.join(path + (key,))}: expected a 2-D kernel")
                out[".".join(path + ("weight",))] = _to_tensor(arr.T)
            else:
                out[".".join(path + (key,))] = _to_tensor(arr)

    walk(params, ())
    return out


def load_flax_params(model: nn.Module, params: dict) -> nn.Module:
    """Copy a flax param tree into ``model`` (every parameter must match by
    name, shape and dtype)."""
    state = flax_to_state_dict(params)
    own = model.state_dict()
    for name, value in state.items():
        if name not in own:
            raise KeyError(f"{name} has no counterpart in {type(model).__name__}")
        if own[name].shape != value.shape or own[name].dtype != value.dtype:
            raise ValueError(
                f"{name}: {tuple(value.shape)} {value.dtype} does not fit "
                f"{tuple(own[name].shape)} {own[name].dtype}"
            )
    model.load_state_dict(state, strict=True)
    return model


def jax_leaf_order(model: nn.Module) -> list[tuple[str, nn.Parameter]]:
    """``model.named_parameters()`` in the order ``jax.tree_util`` flattens
    the corresponding flax tree: dict keys sorted at every level. A torch
    ``weight`` sorts after ``bias`` as flax's ``kernel`` does, so sorting the
    dotted names by component gives the same order. Leaf indices in this
    order key the stochastic rounding of each parameter."""
    return sorted(model.named_parameters(), key=lambda kv: tuple(kv[0].split(".")))
