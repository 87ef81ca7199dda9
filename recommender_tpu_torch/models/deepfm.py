"""DeepFM — FM second-order cross + deep tower over a shared embedding.

Port of ``recommender_tpu/models/deepfm.py::DeepFM`` (replicated table):

* one shared table for all categorical features;
* the FM second-order term by the sum-square / square-sum identity
  (``nn.interactions.fm_cross``; no first-order term), computed in the
  table's dtype;
* a deep tower ``MLP(mlp_units, final_activation=None)`` on [flattened
  embeddings ∥ dense ints];
* output ``sigmoid(fm + deep)``.

Submodule names follow the flax tree (``embedding``, ``mlp/Dense_i``), so
``convert.py`` maps a JAX param tree onto ``state_dict()`` directly.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from recommender_tpu_torch.embedding.table import Embedding
from recommender_tpu_torch.nn.interactions import fm_cross
from recommender_tpu_torch.nn.mlp import MLP


class DeepFM(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        embed_dim: int = 16,
        num_int: int = 13,
        num_cat: int = 26,
        mlp_units: Sequence[int] = (512, 256, 1),
        embed_param_dtype: torch.dtype = torch.float32,
        *,
        partition: Optional[str] = None,
        lookup_mode: str = "gspmd",
        mesh=None,
        capacity_factor: float = 2.0,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_int = num_int
        self.num_cat = num_cat
        self.embedding = Embedding(
            vocab_size, embed_dim, param_dtype=embed_param_dtype, partition=partition,
            lookup_mode=lookup_mode, mesh=mesh, capacity_factor=capacity_factor,
            device=device, generator=generator,
        )
        self.mlp = MLP(
            num_cat * embed_dim + num_int, mlp_units, final_activation=None,
            device=device, generator=generator,
        )

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.embedding.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, batch: dict) -> torch.Tensor:
        ints = batch["int_features"].reshape(-1, self.num_int)
        cats = batch["cat_features"].reshape(-1, self.num_cat)
        emb = self.embedding(cats, dedup_plan=batch.get("cat_dedup"))  # [B, F, D]
        fm = fm_cross(emb)  # [B], in the table dtype
        # a bf16 table: jnp.concatenate promotes bf16 ∥ f32 to f32
        dt = torch.promote_types(emb.dtype, ints.dtype)
        deep_in = torch.cat([emb.reshape(emb.shape[0], -1).to(dt), ints.to(dt)], dim=1)
        deep = torch.squeeze(self.mlp(deep_in), dim=-1)  # [B]
        return torch.sigmoid(fm + deep)
