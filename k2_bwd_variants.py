"""K2's wide fused backward against variants of its own source, on the card.

Each variant is ``recommender_tpu_torch/ops/csrc/flash_attention_bwd.cu``
with a few lines replaced (the replacements below, each asserted to
match), built with the port's flags into ``build/k2_bwd_variants/<name>/``
(``k2_fwd_variants.patched_build``).
Every build's fused backward (``rtt_flash_attention_bwd_fused``) runs on
phase k2's wide cases of ``chip_smoke.py`` with L <= 128, alternated over
two rounds (CUDA events, median of 25 a round), on the saved tensors of
one forward; dq, dk and dv are held against ``flash_mha_ref``'s gradients
and against the shipped build's bit for bit. The variants are
other unrollings, and diagnostics that leave a part out (wrong outputs;
their times split the kernel's time into its parts):

* ``out_unroll4``: dV, dK and dQ take 4 tiles an unrolled iteration, not 2;
* ``score_unroll1``: S^T and dP^T take 1 step of 8 columns an iteration,
  not 2;
* ``no_di``: di = 0 where Dh % 4 == 0, without reading dO and O for it;
* ``no_a``: no S^T or dP^T products (passes S and P);
* ``no_b``: no dV, dK or dQ products and no stores of them;
* ``no_ab``: neither: what is left is the copies, the barriers, di, the
  tile lists, P^T and dS^T.

Run from the repository root on a machine with the card:

    python3 k2_bwd_variants.py [variant ...]

It prints one JSON line a variant with nvcc's registers and spill bytes of
the wide fused kernel, and one a case with every build's times, error and
whether it matches the shipped build bit for bit.
"""
from __future__ import annotations

import ctypes
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
from k2_fwd_variants import patched_build
from recommender_tpu_torch.ops import _build
from recommender_tpu_torch.ops import flash_attention as fa

OUT = _build.BUILD_DIR.parent / "k2_bwd_variants"
_DI = "          for (int c = 4 * sub; c < Dh; c += 64) {"
_A = ("      listed_score_products(slot(u + 1), slot(u), r0, (min(kC, Dh - d * kC) + 7) / 8, nm, mine,",
      "    listed_score_products(slot(u + 1), slot(u), r0, (wd + 7) / 8, nm, mine, l, dp);")
_B = ("    wide_fused_out<true>(dst, lds, r0, slot(u), c0, nl, list, dv,",
      "    wide_fused_out<true>(dst, lds, r0, slot(u), c0, nl, list, dk,",
      "    wide_fused_out<false>(")


def _skip(lines) -> list:
    return [(x, x.replace("    ", "    if (false) ", 1)) for x in lines]


_OUT_LOOP = "#pragma unroll 2\n  for (int kq = 0; kq < nl; ++kq) {"
_SCORE_LOOP = "#pragma unroll 2\n  for (int kk = 0; kk < ks; ++kk) {"
VARIANTS = {
    "shipped": [],
    "out_unroll4": [(_OUT_LOOP, _OUT_LOOP.replace("unroll 2", "unroll 4"))],
    "score_unroll1": [(_SCORE_LOOP, _SCORE_LOOP.replace("unroll 2", "unroll 1"))],
    "no_di": [(_DI, "          for (int c = Dh; c < Dh; c += 64) {")],
    "no_a": _skip(_A),
    "no_b": _skip(_B),
    "no_ab": _skip(_A) + _skip(_B),
}
CASES = ("bst_dh128", "bst_dh72", "dh256")


def build(name: str, replacements: list) -> tuple[Path, dict]:
    """The variant's library and nvcc's registers and spill bytes of its
    wide fused backward."""
    so, report = patched_build("flash_attention_bwd", name, replacements, OUT)
    info, kernel = {}, False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            kernel = "fused_wide" in line
        elif kernel and (m := re.search(r"(\d+) bytes spill stores", line)):
            info["spill_stores"] = int(m[1])
        elif kernel and (m := re.search(r"Used (\d+) registers", line)):
            info["registers"] = int(m[1])
    return so, info


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_bwd_variants: no CUDA device available", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    names = ["shipped", *(n for n in names if n != "shipped")]
    smi = cs.phase_device()
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc a variant, together
        built = dict(zip(names, pool.map(lambda n: build(n, VARIANTS[n]), names)))
    for name, (_, info) in built.items():
        print(json.dumps({"variant": name, "ptxas": info}), flush=True)
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {}
    for name, (so, _) in built.items():
        fn = ctypes.CDLL(str(so)).rtt_flash_attention_bwd_fused
        fn.argtypes, fn.restype = [vp] * 10 + [i32, i32, i32, i32, f32, vp], i32
        fns[name] = fn
    device = torch.device("cuda", 0)
    shapes = cs.k2_shapes(device, cs.bst_data()[0])
    for key in CASES:
        case, valid, heads, head_dim, _, _ = shapes[key]
        B, L = valid.shape
        g = torch.Generator(device=device).manual_seed(cs.SEED)
        q, k, v, cot = (torch.randn((B, L, heads, head_dim), generator=g, device=device)
                        for _ in range(4))
        qkv = [t.requires_grad_() for t in (q, k, v)]
        o = fa.flash_mha_ref(*qkv, valid)
        want = torch.autograd.grad(o, qkv, cot)
        seg = valid.to(torch.int32)
        o, lse = fa._forward(*(t.detach() for t in qkv), seg)
        runs, outs = {}, {}
        for name in names:
            grads = outs[name] = [torch.empty_like(q) for _ in range(3)]
            ptrs = [t.data_ptr() for t in (q, k, v, seg, o, cot, lse, *grads)]
            runs[name] = lambda name=name, ptrs=ptrs: fa._launch(
                "fused backward", fns[name], device, *ptrs, B, L, heads, head_dim,
                1.0 / head_dim ** 0.5)
            runs[name]()
        torch.cuda.synchronize()
        scale = [max(1.0, float(w.abs().max())) for w in want]
        result = {n: {"rel_err": max(float((a - w).abs().max()) / s
                                     for a, w, s in zip(outs[n], want, scale)),
                      "same_bits_as_shipped": all(torch.equal(a, b)
                                                  for a, b in zip(outs[n], outs["shipped"])),
                      "ms": []} for n in runs}
        for r in range(2):
            for name in (list(runs) if r == 0 else list(runs)[::-1]):
                result[name]["ms"].append(cs.cuda_ms(runs[name]))
        print(json.dumps({"case": case, **result}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
