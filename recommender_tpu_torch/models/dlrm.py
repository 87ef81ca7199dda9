"""DLRM — dense-bottom MLP + embedding table + dot interaction + top MLP.

Port of ``recommender_tpu/models/dlrm.py::DLRM``:

* one shared embedding table over all ``num_cat`` categorical features,
  replicated or row-sharded (``partition``, ``lookup_mode``, ``mesh``,
  ``capacity_factor``: ``embedding.table.Embedding``);
* bottom MLP on the ``num_int`` dense features, its output used as one more
  feature (so ``bottom_units[-1]`` must equal ``embed_dim``);
* ``DotInteraction(self_interaction=False, skip_gather=True)`` → dense
  ``(num_cat+1)^2`` output;
* top MLP on [interaction ∥ bottom output] → sigmoid probability.

Submodule and parameter names follow the flax tree (``embedding``,
``bottom_mlp/Dense_i``, ``top_mlp/Dense_i``) so ``convert.py`` maps a JAX
param tree onto ``state_dict()`` directly.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from recommender_tpu_torch.embedding.table import Embedding
from recommender_tpu_torch.nn.interactions import DotInteraction
from recommender_tpu_torch.nn.mlp import MLP


class DLRM(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        embed_dim: int = 16,
        num_int: int = 13,
        num_cat: int = 26,
        bottom_units: Sequence[int] = (512, 256, 64, 16),
        top_units: Sequence[int] = (512, 256, 1),
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
        if bottom_units[-1] != embed_dim:
            raise ValueError(
                f"bottom_units[-1] ({bottom_units[-1]}) must equal embed_dim ({embed_dim})"
            )
        self.num_int = num_int
        self.num_cat = num_cat
        n_feat = num_cat + 1
        # construction order = init order: table, bottom, top
        self.embedding = Embedding(
            vocab_size, embed_dim, param_dtype=embed_param_dtype, partition=partition,
            lookup_mode=lookup_mode, mesh=mesh, capacity_factor=capacity_factor,
            device=device, generator=generator,
        )
        self.bottom_mlp = MLP(
            num_int, bottom_units, final_activation=F.relu,
            device=device, generator=generator,
        )
        self.top_mlp = MLP(
            n_feat * n_feat + embed_dim, top_units, final_activation=torch.sigmoid,
            device=device, generator=generator,
        )
        self.interaction = DotInteraction(self_interaction=False, skip_gather=True)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.embedding.reset_parameters(generator)
        self.bottom_mlp.reset_parameters(generator)
        self.top_mlp.reset_parameters(generator)

    def forward(self, batch: dict) -> torch.Tensor:
        ints = batch["int_features"].reshape(-1, self.num_int)
        cats = batch["cat_features"].reshape(-1, self.num_cat)
        cat_emb = self.embedding(cats, dedup_plan=batch.get("cat_dedup"))  # [B, F, D]
        bottom = self.bottom_mlp(ints)  # [B, D] f32
        # the bf16-table case: jnp.concatenate promotes bf16 ∥ f32 to f32
        dt = torch.promote_types(cat_emb.dtype, bottom.dtype)
        feats = torch.cat([cat_emb.to(dt), bottom[:, None, :].to(dt)], dim=1)
        inter = self.interaction(feats)  # [B, (F+1)^2]
        top_in = torch.cat([inter, bottom], dim=1)
        prob = self.top_mlp(top_in)
        return torch.squeeze(prob, dim=-1)
