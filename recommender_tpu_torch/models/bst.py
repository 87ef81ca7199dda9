"""BST — Behavior Sequence Transformer over the DIEN batch schema.

Port of ``recommender_tpu/models/bst.py::BST``: self-attention with learned
positions over [history ∥ target]; the head gets [target-position output ∥
masked mean of the history outputs] (the JAX package's documented readout
divergence from the paper). Submodules carry the flax names
(``item_embedding``, ``cat_embedding``, ``block_0 … block_{n-1}``,
``positions``, ``mlp``), so ``convert.py`` maps a JAX tree one to one.

The constructor takes the JAX model's fields (plus the port's ``device``
and ``generator``). Attention runs the plain path unless a block's
``use_flash`` attribute is set (``for blk in model.blocks(): blk.use_flash
= True``), as on the JAX block; BST has no field for it.

A history longer than ``max_len - 1`` raises: under XLA the JAX model's
position lookup silently clamps the ids instead.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from recommender_tpu_torch.models.dien import SequenceBase
from recommender_tpu_torch.nn.mlp import lecun_normal_
from recommender_tpu_torch.nn.sequence import masked_mean_pool
from recommender_tpu_torch.nn.transformer import TransformerBlock


class Embed(nn.Module):
    """flax ``nn.Embed``'s parameter: ``embedding`` [num, features], drawn
    from ``variance_scaling(1.0, "fan_in", "normal", out_axis=0)`` — a normal
    truncated at ±2σ with variance 1/features."""

    def __init__(self, num: int, features: int, *, device=None, generator=None):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.empty((num, features), dtype=torch.float32, device=device)
        )
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        lecun_normal_(self.embedding, generator)


class BST(SequenceBase):
    def __init__(
        self,
        item_vocab: int,
        cat_vocab: int,
        item_dim: int = 18,
        cat_dim: int = 18,
        mlp_units: Sequence[int] = (200, 80, 1),
        partition: Optional[str] = None,
        lookup_mode: str = "gspmd",
        mesh: Optional[object] = None,
        shared_gather: bool = False,
        embed_param_dtype: torch.dtype = torch.float32,
        num_heads: int = 4,
        num_blocks: int = 2,
        ffn_mult: int = 4,
        max_len: int = 512,  # position table size; histories up to max_len-1
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(
            item_vocab, cat_vocab, item_dim, cat_dim, mlp_units, partition,
            lookup_mode, mesh, shared_gather, embed_param_dtype,
            device=device, generator=generator,
        )
        self.max_len = max_len
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(
                f"block_{i}",
                TransformerBlock(self.dim, num_heads, ffn_mult, device=device, generator=generator),
            )
        self.positions = Embed(max_len, self.dim, device=device, generator=generator)

    def blocks(self) -> list[TransformerBlock]:
        return [getattr(self, f"block_{i}") for i in range(self.num_blocks)]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        super().reset_parameters(generator)
        for blk in self.blocks():
            blk.reset_parameters(generator)
        self.positions.reset_parameters(generator)

    def forward(self, batch: dict) -> torch.Tensor:
        his_item = batch["pos_his_item"]
        mask = (his_item != 0).to(torch.float32)  # [B, T]
        target, his = self.embed_sets(
            [batch["target_item"], his_item],
            [batch["target_cat"], batch["pos_his_cat"]],
        )  # [B, D], [B, T, D]
        B, T = mask.shape
        if T + 1 > self.max_len:
            raise ValueError(
                f"history length {T} needs {T + 1} positions; max_len is {self.max_len}"
            )
        # sequence = history steps 0..T-1, target at position T
        seq = torch.cat([his, target[:, None, :]], dim=1)  # [B, T+1, D]
        valid = torch.cat([mask, mask.new_ones((B, 1))], dim=1)  # [B, T+1]
        x = seq + self.positions.embedding[: T + 1][None]
        for blk in self.blocks():
            x = blk(x, valid)
        pooled = masked_mean_pool(x[:, :-1], mask)
        return self.head(x[:, -1], pooled)
