"""JAX variables → the port's ``state_dict``.

The input is a flax param tree as a nested dict of numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``), and optionally the ``batch_stats``
collection; no jax is needed here. Names map one to one because the port's
modules carry the flax names:

* a 2-D ``kernel`` [in, out] (``nn.Dense``) → ``weight`` [out, in]
  (transposed, the layout of ``torch.nn.Linear``), e.g.
  ``bottom_mlp/Dense_0/kernel`` → ``bottom_mlp.Dense_0.weight``;
* any other ``kernel`` (``nn.DenseGeneral``: ``qkv`` [in, 3, H, Dh], ``out``
  [H, Dh, out]) → ``kernel`` in its own shape (the port's ``DenseGeneral``);
* ``scale`` (LayerNorm, BatchNorm) → ``weight``;
* ``bias`` and ``embedding`` (``Embedding`` tables, ``nn.Embed``) as is;
* ``batch_stats`` ``…/BatchNorm_0/{mean, var}`` → the BatchNorm buffers of
  the same names.

bf16 arrays (numpy's ``bfloat16`` extension dtype) keep their bits.

``load_flax_params`` into a model with row-sharded tables (a ``mesh`` with
a model axis wider than 1, ``parallel.partitioning``) keeps this rank's
rows of each whole table of the JAX tree, so a JAX init loads into a
sharded port as it does into a whole one.
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


def flax_to_state_dict(params: dict, batch_stats: dict | None = None) -> dict[str, torch.Tensor]:
    """Flatten a flax param tree (and ``batch_stats``) into ``state_dict``
    entries (CPU tensors)."""
    out: dict[str, torch.Tensor] = {}

    def walk(tree: dict, path: tuple, rename: bool):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + (key,), rename)
                continue
            arr = np.asarray(value)
            if rename and key == "kernel" and arr.ndim == 2:
                key, arr = "weight", arr.T
            elif rename and key == "scale":
                key = "weight"
            out[".".join(path + (key,))] = _to_tensor(arr)

    walk(params, (), rename=True)
    walk(batch_stats or {}, (), rename=False)
    return out


def load_flax_params(model: nn.Module, params: dict, batch_stats: dict | None = None) -> nn.Module:
    """Copy a flax param tree, and the ``batch_stats`` collection where the
    model has BatchNorm buffers, into ``model``: every entry of its
    ``state_dict`` must be matched by name, shape and dtype, a row shard by
    its rows of the whole table."""
    from recommender_tpu_torch.parallel.partitioning import row_sharded_params

    state = flax_to_state_dict(params, batch_stats)
    own = model.state_dict()
    for name, (lo, vocab) in row_sharded_params(model).items():
        if name in state and state[name].shape[0] == vocab:
            state[name] = state[name][lo:lo + own[name].shape[0]].clone()
    for name, value in state.items():
        if name not in own:
            raise KeyError(f"{name} has no counterpart in {type(model).__name__}")
        if own[name].shape != value.shape or own[name].dtype != value.dtype:
            raise ValueError(
                f"{name}: {tuple(value.shape)} {value.dtype} does not fit "
                f"{tuple(own[name].shape)} {own[name].dtype}"
            )
    model.load_state_dict(state, strict=True)  # raises on a missing entry
    return model


def jax_leaf_order(model: nn.Module) -> list[tuple[str, nn.Parameter]]:
    """``model.named_parameters()`` in the order ``jax.tree_util`` flattens
    the corresponding flax tree: dict keys sorted at every level. A torch
    ``weight`` sorts after ``bias`` as flax's ``kernel`` does, so sorting the
    dotted names by component gives the same order. Leaf indices in this
    order key the stochastic rounding of each parameter."""
    return sorted(model.named_parameters(), key=lambda kv: tuple(kv[0].split(".")))
