"""DCNv2 — cross network ∥ deep tower over the shared Criteo embedding.

Port of ``recommender_tpu/models/dcn.py::DCN`` (replicated table), the
"parallel" variant of Wang et al. 2021: x0 = [flattened embeddings (f32) ∥
dense ints] → ``CrossNetwork(x0)`` ∥ ``MLP(deep_units, relu)(x0)`` →
concat → ``head`` ``Linear(·, 1)`` → sigmoid. The same batch contract as
``DLRM`` and ``DeepFM`` (``cat_dedup`` plans included).

Submodule names follow the flax tree (``embedding``, ``cross/cross_i``,
``deep/Dense_i``, ``head``), so ``convert.py`` maps a JAX param tree onto
``state_dict()`` directly.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from recommender_tpu_torch.embedding.table import Embedding
from recommender_tpu_torch.nn.cross import CrossNetwork
from recommender_tpu_torch.nn.mlp import MLP, lecun_normal_


class DCN(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        embed_dim: int = 16,
        num_int: int = 13,
        num_cat: int = 26,
        cross_layers: int = 3,
        deep_units: Sequence[int] = (512, 256),
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
        width = num_cat * embed_dim + num_int
        self.embedding = Embedding(
            vocab_size, embed_dim, param_dtype=embed_param_dtype, partition=partition,
            lookup_mode=lookup_mode, mesh=mesh, capacity_factor=capacity_factor,
            device=device, generator=generator,
        )
        self.cross = CrossNetwork(width, cross_layers, device=device, generator=generator)
        self.deep = MLP(width, deep_units, final_activation=F.relu, device=device,
                        generator=generator)
        self.head = nn.utils.skip_init(
            nn.Linear, width + deep_units[-1], 1,
            device=torch.device("cpu") if device is None else device, dtype=torch.float32,
        )
        self._reset_head(generator)

    @torch.no_grad()
    def _reset_head(self, generator):
        lecun_normal_(self.head.weight, generator)
        self.head.bias.zero_()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.embedding.reset_parameters(generator)
        self.cross.reset_parameters(generator)
        self.deep.reset_parameters(generator)
        self._reset_head(generator)

    def forward(self, batch: dict) -> torch.Tensor:
        ints = batch["int_features"].reshape(-1, self.num_int)
        cats = batch["cat_features"].reshape(-1, self.num_cat)
        emb = self.embedding(cats, dedup_plan=batch.get("cat_dedup"))
        x0 = torch.cat([emb.reshape(emb.shape[0], -1).to(torch.float32), ints], dim=1)
        out = torch.cat([self.cross(x0), self.deep(x0)], dim=1)
        return torch.sigmoid(torch.squeeze(self.head(out), dim=-1))
