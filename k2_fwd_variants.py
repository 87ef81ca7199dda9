"""K2's wide forward against variants of its own source, on the card.

Each variant is ``recommender_tpu_torch/ops/csrc/flash_attention.cu`` with a
few lines replaced (the replacements below, each asserted to match), built
with the port's flags into ``build/k2_fwd_variants/<name>/``. Every build's
long wide forward (and split_rna's fused one, the only variant that changes
it) runs on phase k2's wide cases of ``chip_smoke.py``, alternated over two
rounds (CUDA events, median of 25 a round); the output is held against
``flash_mha_ref`` and against the shipped build's bit for bit. The
variants:

* ``three_blocks``: three long blocks an SM at NC = 2 (a ring of 2 slots,
  at most 168 registers) instead of two;
* ``branch_per_tile``: the loops as first written, a branch before every
  tile's products in S and before every column group's in P V;
* ``split_rna``: K's and V's TF32 split by ``cvt.rna.tf32.f32`` (the same
  rounding, one instruction) instead of an integer add and mask;
* ``no_s``, ``no_pv``, ``neither``: diagnostics that skip the long
  kernel's S products, its P V products or both (wrong outputs; their
  times split the kernel's time into its parts).

Run from the repository root on a machine with the card:

    python3 k2_fwd_variants.py [variant ...]

It prints one JSON line a variant with nvcc's registers and spill bytes of
the two wide kernels, and one a case with every build's times, error and
whether it matches the shipped build bit for bit.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
from recommender_tpu_torch.ops import _build
from recommender_tpu_torch.ops import flash_attention as fa

OUT = _build.BUILD_DIR.parent / "k2_fwd_variants"
_S_CALL = "        wide_score_products<kBlockTiles>(qt, kt, r0, 0, (min(kC, Dh - d * kC) + 7) / 8, every,"
_PV_CALL = "      if (mk.live)\n        wide_pv_swz("
VARIANTS = {
    "shipped": [],
    "three_blocks": [
        ("constexpr int wide_fwd_slots(int NC) { return NC == 2 ? 6 : 7; }",
         "constexpr int wide_fwd_slots(int NC) { return NC == 2 ? 4 : 7; }"),
        ("__launch_bounds__(kLongThreads, 2)\nflash_fwd_wide_long_kernel",
         "__launch_bounds__(kLongThreads, NC == 2 ? 3 : 2)\nflash_fwd_wide_long_kernel"),
    ],
    "branch_per_tile": [
        ("      if (d == 0) mk = block_mask(st, seg_s + (t & 1) * kTile, n, 0, ln);",
         "      if (d == 0) mk = block_mask(st, seg_s + (t & 1) * kTile, n, 0, ln);\n"
         "      for (int jt = 0; jt < kBlockTiles; ++jt) every[jt] = mk.live >> jt & 1;"),
        ("    if (nw == kC / 8) {\n#pragma unroll\n      for (int nn = 0; nn < kC / 8; ++nn)\n"
         "        mma3(o[nn]", "    if (false) {\n#pragma unroll\n      for (int nn = 0; nn < kC / 8; ++nn)\n"
         "        mma3(o[nn]"),
    ],
    "split_rna": [
        ("template <int NC>\n__device__ __forceinline__ void wide_softmax(",
         "__device__ __forceinline__ FragB split_b_rna(float b0, float b1) {\n"
         "  FragB f;\n"
         "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(f.hi[0]) : \"f\"(b0));\n"
         "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(f.hi[1]) : \"f\"(b1));\n"
         "  f.lo[0] = __float_as_uint(b0 - __uint_as_float(f.hi[0]));\n"
         "  f.lo[1] = __float_as_uint(b1 - __uint_as_float(f.hi[1]));\n"
         "  return f;\n}\n\ntemplate <int NC>\n__device__ __forceinline__ void wide_softmax("),
        ("split_b(x0[nn & 3]", "split_b_rna(x0[nn & 3]"),
        ("split_b(k.p[kr[jt]", "split_b_rna(k.p[kr[jt]"),
        ("split_b(v0[c * kC", "split_b_rna(v0[c * kC"),
        # the long kernel's S through a copy of wide_score_products that splits K so too
        ("        wide_score_products<kBlockTiles>(", "        wide_score_products_rna<kBlockTiles>("),
        ("// ------------------------------------------------------------ wide long route",
         "template <int NT>\n__device__ __forceinline__ void wide_score_products_rna(\n"
         "    const float* x, const float* y, int r0, int j0, int ks, const bool (&live)[NT], Lane l,\n"
         "    float (&acc)[NT][4]) {\n"
         "  const int sw = 4 * l.g, ra = (r0 + l.g) * kC, rb = (j0 + l.g) * kC;\n"
         "#pragma unroll 2\n  for (int kk = 0; kk < ks; ++kk) {\n"
         "    const int c = (8 * kk + l.t) ^ sw, c4 = c ^ 4;\n"
         "    const FragA a = split_a(x[ra + c], x[ra + 8 * kC + c], x[ra + c4], x[ra + 8 * kC + c4]);\n"
         "#pragma unroll\n    for (int i = 0; i < NT; ++i)\n"
         "      if (live[i]) mma3(acc[i], a, split_b_rna(y[rb + 8 * i * kC + c], y[rb + 8 * i * kC + c4]));\n"
         "  }\n}\n\n// ------------------------------------------------------------ wide long route"),
    ],
    "no_s": [(_S_CALL, "        if (false) " + _S_CALL.lstrip())],
    "no_pv": [(_PV_CALL, "      if (false)\n        wide_pv_swz(")],
    "neither": [(_S_CALL, "        if (false) " + _S_CALL.lstrip()),
                (_PV_CALL, "      if (false)\n        wide_pv_swz(")],
}
CASES = (("r5_dh128", "fwd_long"), ("dh256", "fwd_long"), ("bst_dh128", "fwd_long"),
         ("bst_dh128", "fwd_fused"), ("bst_dh72", "fwd_fused"))


def patched_build(source: str, name: str, replacements: list, out: Path) -> tuple[Path, str]:
    """``csrc/<source>.cu`` with each (old, new) replaced once it is found,
    built with the port's flags and ``-Xptxas -v`` into ``out/<name>/``:
    the library and nvcc's report."""
    src = out / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, src)
    cu = src / f"{source}.cu"
    text = cu.read_text()
    for old, new in replacements:
        if old not in text:
            raise RuntimeError(f"{name}: no match for {old!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    so = src / f"lib{source}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return so, proc.stderr


def build(name: str, replacements: list) -> tuple[Path, dict]:
    """The variant's library and nvcc's registers and spill bytes of its
    wide forward kernels."""
    so, report = patched_build("flash_attention", name, replacements, OUT)
    info, kernel = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(wide_long|fused)_kernelILi(?:64ELb0ELi)?([24])E", line)
            kernel = f"{m[1]}_nc{m[2]}" if m else None
        elif kernel and (m := re.search(r"(\d+) bytes spill stores", line)):
            info.setdefault(kernel, {})["spill_stores"] = int(m[1])
        elif kernel and (m := re.search(r"Used (\d+) registers", line)):
            info.setdefault(kernel, {})["registers"] = int(m[1])
    return so, info


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_fwd_variants: no CUDA device available", file=sys.stderr)
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
        lib = ctypes.CDLL(str(so))
        for entry in ("fwd_long", "fwd_fused"):
            fn = getattr(lib, f"rtt_flash_attention_{entry}")
            fn.argtypes, fn.restype = [vp] * 6 + [i32, i32, i32, i32, f32, vp], i32
            fns[name, entry] = fn
    device = torch.device("cuda", 0)
    shapes = cs.k2_shapes(device, cs.bst_data()[0])
    for key, entry in CASES:
        case, valid, heads, head_dim, _, _ = shapes[key]
        B, L = valid.shape
        g = torch.Generator(device=device).manual_seed(cs.SEED)
        q, k, v = (torch.randn((B, L, heads, head_dim), generator=g, device=device)
                   for _ in range(3))
        seg = valid.to(torch.int32)
        want = fa.flash_mha_ref(q, k, v, valid)
        runs, outs = {}, {}
        # only split_rna changes the fused kernel
        for name in (n for n in names if entry == "fwd_long" or n in ("shipped", "split_rna")):
            o = outs[name] = torch.empty_like(q)
            lse = torch.empty((B, heads, L), device=device)
            ptrs = [t.data_ptr() for t in (q, k, v, seg, o, lse)]
            runs[name] = lambda name=name, ptrs=ptrs: fa._launch(
                entry, fns[name, entry], device, *ptrs, B, L, heads, head_dim, 1.0 / head_dim ** 0.5)
            runs[name]()
        torch.cuda.synchronize()
        scale = max(1.0, float(want.abs().max()))
        result = {n: {"rel_err": float((outs[n] - want).abs().max()) / scale,
                      "same_bits_as_shipped": bool(torch.equal(outs[n], outs["shipped"])),
                      "ms": []} for n in runs}
        for r in range(2):
            for name in (list(runs) if r == 0 else list(runs)[::-1]):
                result[name]["ms"].append(cs.cuda_ms(runs[name]))
        print(json.dumps({"case": case, "entry": entry, **result}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
