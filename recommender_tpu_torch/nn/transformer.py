"""Post-LN transformer encoder block for behavior sequences (BST).

Port of ``recommender_tpu/nn/transformer.py::TransformerBlock``, computed in
f32 as the flax block is. Submodules carry the flax names (``qkv``, ``out``,
``Dense_0``, ``Dense_1``, ``LayerNorm_0``, ``LayerNorm_1``) so that
``convert.py`` maps a JAX param tree one to one; ``qkv`` and ``out`` keep
``nn.DenseGeneral``'s kernel shapes, ``(dim, 3, H, Dh)`` and ``(H, Dh, dim)``.

Masking contract: pad positions (``valid == 0``) are excluded as keys; pad
queries produce outputs that the caller's masked readout never reads.

Two attention paths over one parameter set, chosen by the ``use_flash``
attribute (``None``/``False`` = plain, ``True`` = flash), as in the JAX block:

* plain: the [B, H, L, L] scores with a ``-1e30`` key mask and a softmax,
  in plain PyTorch (XLA's fused plain path in the JAX package);
* flash: ``ops.flash_attention.flash_mha``, the hand-written CUDA kernels
  (the Pallas TPU flash attention in the JAX package). Its pad query rows
  differ from the plain path's (segment-equality mask); valid rows agree.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from recommender_tpu_torch.nn.mlp import lecun_normal_
from recommender_tpu_torch.ops.flash_attention import flash_mha


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` with its kernel in its own shape,
    ``in_shape + out_shape``: contracts the last ``len(in_shape)`` axes of
    the input, then adds ``bias`` [*out_shape]."""

    def __init__(
        self,
        in_shape: Sequence[int],
        out_shape: Sequence[int],
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.n_in = len(in_shape)
        self.fan_in = math.prod(in_shape)
        f32 = dict(dtype=torch.float32, device=device)
        self.kernel = nn.Parameter(torch.empty(*in_shape, *out_shape, **f32))
        self.bias = nn.Parameter(torch.empty(*out_shape, **f32))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax init: lecun-normal over the flattened (in, out) kernel, zero bias."""
        lecun_normal_(self.kernel, generator, fan_in=self.fan_in)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(x, self.kernel, dims=self.n_in) + self.bias


class TransformerBlock(nn.Module):
    """MHSA + FFN, each with residual + LayerNorm (post-LN, BST-style)."""

    def __init__(
        self,
        dim: int,
        num_heads: int = 2,
        ffn_mult: int = 4,
        use_flash: Optional[bool] = None,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.use_flash = use_flash
        H, Dh = num_heads, self.head_dim
        self.qkv = DenseGeneral((dim,), (3, H, Dh), device=device, generator=generator)
        self.out = DenseGeneral((H, Dh), (dim,), device=device, generator=generator)
        # flax LayerNorm: epsilon 1e-6, where torch's default is 1e-5
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=1e-6, device=device)
        hidden = dim * ffn_mult
        device = torch.device("cpu") if device is None else device
        self.Dense_0 = nn.utils.skip_init(nn.Linear, dim, hidden, device=device)
        self.Dense_1 = nn.utils.skip_init(nn.Linear, hidden, dim, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax init: lecun-normal kernels, zero biases, LayerNorm scale 1."""
        self.qkv.reset_parameters(generator)
        self.out.reset_parameters(generator)
        for dense in (self.Dense_0, self.Dense_1):
            lecun_normal_(dense.weight, generator)
            dense.bias.zero_()
        self.LayerNorm_0.reset_parameters()
        self.LayerNorm_1.reset_parameters()

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """x: [B, L, D] f32; valid: [B, L] (1 = real position, 0 = pad —
        pads are masked out as attention keys)."""
        q, k, v = self.qkv(x).unbind(dim=2)  # each [B, L, H, Dh]
        if self.use_flash:
            o = flash_mha(q, k, v, valid)
        else:
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / (self.head_dim ** 0.5)
            s = torch.where(valid[:, None, None, :] > 0, s, -1e30)
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        x = self.LayerNorm_0(x + self.out(o))
        f = self.Dense_1(F.relu(self.Dense_0(x)))
        return self.LayerNorm_1(x + f)
