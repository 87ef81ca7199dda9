"""Recurrent sequence layers: the masked GRU and the attention-gated AUGRU.

Port of ``recommender_tpu/nn/recurrent.py``. The JAX layers are one
``lax.scan`` each; here each is an eager Python loop over the T steps, in
plain PyTorch (the JAX package has no hand-written kernel behind its
recurrences either).

The cell is DIEN's, **not** cuDNN's GRU (``torch.nn.GRU`` computes another
function and takes neither the mask nor the score):

    z, r = sigmoid([h, x] @ w_gates + b_gates)
    c    = tanh([x, r*h] @ w_cand + b_cand)       # reset gate before the product
    h'   = (1 - z) * h + z * c                     # AUGRU: z scaled by the score
    h    = h' at real steps, h at masked steps

Parameters keep the JAX layout and names: ``w_gates`` [H+D, 2H] whose rows
``[:H]`` multiply h and rows ``[H:]`` multiply x, and ``w_cand`` [H+D, H]
whose rows ``[:D]`` multiply x and rows ``[D:]`` multiply ``r*h`` — the other
way round. The input halves of both products are hoisted out of the loop as
two [T·B, D] matmuls; only the h-dependent halves run per step.

``remat`` recomputes the steps on the backward pass
(``torch.utils.checkpoint``) in chunks of ``REMAT_CHUNK`` steps instead of
storing every step's activations: ``None`` (default) turns it on for
T > ``REMAT_MIN_T``. The recomputation repeats the same operations on the
same values, so the results are those of ``remat=False`` bit for bit and
the gradients to f32 roundoff (a chunk's share of a gradient is summed on
its own before it joins the others'). The
JAX layers' ``unroll`` is a loop control of XLA's with no counterpart here.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from recommender_tpu_torch.nn.mlp import lecun_normal_

# Above this length the steps are rematerialized by default.
REMAT_MIN_T = 256
# Steps per checkpointed chunk: the chunk boundaries' states are stored, and
# one chunk's activations live at a time during the backward pass.
REMAT_CHUNK = 32


def _effective_remat(remat: Optional[bool], t: int) -> bool:
    return (t > REMAT_MIN_T) if remat is None else remat


def _gru_steps(h, zr_x, c_x, ms, wh_gates, wh_cand):
    """Steps of the masked GRU from state ``h`` [B, H] over the time-major
    hoisted projections ``zr_x`` [n, B, 2H], ``c_x`` [n, B, H] and mask
    ``ms`` [n, B, 1]. Returns the n states, stacked batch-major [B, n, H]."""
    hs = []
    for zr_t, c_t, mt in zip(zr_x, c_x, ms):
        z, r = torch.sigmoid(torch.addmm(zr_t, h, wh_gates)).chunk(2, dim=-1)
        c = torch.tanh(torch.addmm(c_t, r * h, wh_cand))
        new = torch.lerp(h, c, z)  # (1 - z) * h + z * c
        h = torch.lerp(h, new, mt)  # masked steps carry the state through
        hs.append(h)
    return torch.stack(hs, dim=1)


def _augru_steps(h, zr_x, c_x, att, ms, wh_gates, wh_cand):
    """Steps of the masked AUGRU: as ``_gru_steps`` with the update gate
    scaled by the score ``att`` [n, B, 1]. Returns the last state [B, H]."""
    for zr_t, c_t, at, mt in zip(zr_x, c_x, att, ms):
        z, r = torch.sigmoid(torch.addmm(zr_t, h, wh_gates)).chunk(2, dim=-1)
        c = torch.tanh(torch.addmm(c_t, r * h, wh_cand))
        new = torch.lerp(h, c, z * at)  # attention-scaled update gate
        h = torch.lerp(h, new, mt)
    return h


class _GRUBase(nn.Module):
    """Parameters and hoisted input projections shared by GRU and AUGRU."""

    def __init__(self, input_dim: int, hidden: int, remat: Optional[bool] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dim = input_dim
        self.hidden = hidden
        self.remat = remat
        f32 = dict(dtype=torch.float32, device=device)
        self.w_gates = nn.Parameter(torch.empty((hidden + input_dim, 2 * hidden), **f32))
        self.b_gates = nn.Parameter(torch.empty((2 * hidden,), **f32))
        self.w_cand = nn.Parameter(torch.empty((hidden + input_dim, hidden), **f32))
        self.b_cand = nn.Parameter(torch.empty((hidden,), **f32))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax init: lecun-normal [in, out] kernels, zero biases."""
        fan_in = self.hidden + self.input_dim
        lecun_normal_(self.w_gates, generator, fan_in=fan_in)
        lecun_normal_(self.w_cand, generator, fan_in=fan_in)
        self.b_gates.zero_()
        self.b_cand.zero_()

    def _hoisted(self, x: torch.Tensor, mask: torch.Tensor):
        """Time-major input projections [T, B, 2H] and [T, B, H], the mask
        [T, B, 1], and the h-side weights."""
        h, d = self.hidden, self.input_dim
        xs = x.transpose(0, 1)  # [T, B, D]
        ms = mask.to(x.dtype).transpose(0, 1)[..., None]
        zr_x = torch.matmul(xs, self.w_gates[h:]) + self.b_gates
        c_x = torch.matmul(xs, self.w_cand[:d]) + self.b_cand
        return zr_x, c_x, ms, self.w_gates[:h], self.w_cand[d:]

    def _chunks(self, t: int) -> list[slice]:
        """The loop as one chunk, or as checkpointed chunks under remat."""
        if not (_effective_remat(self.remat, t) and torch.is_grad_enabled()):
            return [slice(0, t)]
        return [slice(s, min(s + REMAT_CHUNK, t)) for s in range(0, t, REMAT_CHUNK)]


class GRU(_GRUBase):
    """Masked GRU over ``x`` [B, T, D] with ``mask`` [B, T]; returns all
    hidden states [B, T, H]."""

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        zr_x, c_x, ms, wh_gates, wh_cand = self._hoisted(x, mask)
        h = x.new_zeros((b, self.hidden))
        chunks = self._chunks(t)
        out = []
        for sl in chunks:
            args = (h, zr_x[sl], c_x[sl], ms[sl], wh_gates, wh_cand)
            if len(chunks) > 1:
                hs = checkpoint(_gru_steps, *args, use_reentrant=False)
            else:
                hs = _gru_steps(*args)
            h = hs[:, -1]
            out.append(hs)
        return out[0] if len(out) == 1 else torch.cat(out, dim=1)


class AUGRU(_GRUBase):
    """Attention-gated GRU: consumes hidden states ``x`` [B, T, D], scores
    ``att`` [B, T, 1] and ``mask`` [B, T]; returns the final state [B, H]."""

    def forward(self, x: torch.Tensor, att: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        zr_x, c_x, ms, wh_gates, wh_cand = self._hoisted(x, mask)
        as_ = att.transpose(0, 1)  # [T, B, 1]
        h = x.new_zeros((b, self.hidden))
        chunks = self._chunks(t)
        for sl in chunks:
            args = (h, zr_x[sl], c_x[sl], as_[sl], ms[sl], wh_gates, wh_cand)
            if len(chunks) > 1:
                h = checkpoint(_augru_steps, *args, use_reentrant=False)
            else:
                h = _augru_steps(*args)
        return h
