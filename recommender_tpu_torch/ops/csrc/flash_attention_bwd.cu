// Flash attention backward with a segment-id mask, for head dims up to 64,
// on the tensor cores at f32 accuracy.
//
// Replaces the TPU kernels _flash_attention_bwd_dkv and _flash_attention_bwd_dq
// of jax 0.9.0's jax/experimental/pallas/ops/tpu/flash_attention.py (:941,
// :1287), which recommender_tpu/nn/transformer.py::_flash_mha reaches. With
// P the forward's probabilities over the keys j with seg[b, j] == seg[b, i]
// (recomputed from q, k and the forward's log-sum-exp) and
// di = rowsum(dO * O), it computes
//
//     dV = P^T dO,  dS = P * (dO V^T - di),  dK = scale dS^T Q,  dQ = scale dS K.
//
// Layout as the forward (flash_attention.cu): q, k, v, o, dO, dQ, dK, dV f32
// [B, L, H, Dh] (heads-last, contiguous); seg int32 [B, L]; lse, di f32
// [B, H, L].
//
// Two routes; ops/flash_attention.py::bwd_route picks one from (L, H, Dh):
// * fused (L <= 128 and fused_smem_bytes(L, H, Dh) <= 227 KB; BST's
//   B1024 L101 H4 Dh9 takes it): one block per batch row b replaces both TPU
//   kernels. It computes di itself, and for each head S, P, dP and dS once.
// * long (any other shape, e.g. the B128 L1001 probes): a dK/dV kernel that
//   owns 64 keys and streams the queries, and a dQ kernel that owns 64
//   queries and streams the keys, as the two TPU kernels do; di comes from
//   the caller.
//
// What bounds them on an H100 80GB HBM3 (3.35 TB/s; TF32 tensor cores 495
// TFLOP/s, three TF32 products per f32 product), every pair counted:
// * BST, fused: 121 MB in and out (q, k, v, o, dO, lse, seg; dq, dk, dv) ->
//   36 us; 10 L^2 Dh per (b, h) = 3.8 GFLOP -> 23 us. Bytes bound it.
// * B128 L1001 H4 Dh64, long: dK/dV 2.6e11 FLOP -> 1.6 ms (0.79 GB -> 0.24
//   ms), dQ 2.0e11 FLOP -> 1.2 ms (0.66 GB -> 0.20 ms). Operations bound it.
// They run at 12-22% of these bounds (times: PERF.md, from chip_smoke.py
// phase k2). Each 16 x 8 step is a dependent chain (shared loads, split, the
// S and dP products, exp2, the split of P and dS, the dV and dK products),
// and the warps resident on an SM (14 for the fused kernel, whose 110 KB
// block allows two an SM) do not hide it.
//
// What the design does about what held the earlier kernels (one query or key
// row per thread, FMA loops over shared rows) back:
// 1. Their inner loop was bound by shared-memory loads, two dot products and
//    two accumulations of DPAD floats per pair. Here every product is a warp's
//    mma.sync on TF32 tensor cores, split 3xTF32 (x = hi + lo, both TF32;
//    a*b = hi*hi + hi*lo + lo*hi, summed in f32) so the result keeps f32
//    accuracy where one TF32 product keeps ~3 digits. A warp keeps its own
//    16 rows as A fragments in registers (already split where DP <= 32); the
//    other side's rows are read from shared memory once per 16 x 8 tile. Dh
//    is padded to DP, a multiple of 8, in registers only: A reads past Dh
//    give 0. Where Dh % 8 is 1..4 (BST's 9) the last 8 columns of S and dP
//    take a k = 4 product. A 16 x 8 tile in which the segment mask keeps no
//    pair is skipped (a warp vote on the seg ids): it would add exact zeros.
// 2. The two kernels each recomputed S and dP. The fused route computes them
//    once, keeps dS^T of one head in shared memory and reads dQ = dS K from it.
//    The long route still recomputes (no atomics, as before).
// 3. L 101 ran in 64-row tiles (21% idle rows). The fused route works in
//    16-row warp tiles (112 rows for 101) and 8-column steps.
// 4. Loads were scalar, with a divide per element, and read 36-byte pieces of
//    144-byte rows. The fused block copies each tensor's [L, H, Dh] span of
//    its batch row as one contiguous run of 16-byte cp.async copies (4-byte
//    where the span is not 16-byte aligned) and reads the heads out of it in
//    place. The long route double-buffers its 64-row tiles with cp.async,
//    16 bytes a copy where Dh % 4 == 0.
// 5. di = rowsum(dO * O) cost four launches in the wrapper. The fused kernel
//    computes it from dO in shared memory and O.
// Each output element is written once, by one lane, with no atomics: every
// launch is bitwise deterministic.
//
// C interface for ctypes: pointers and the stream as void*; each entry
// returns cudaGetLastError() after its launch (cudaErrorInvalidValue for a
// shape it does not take).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kFusedMaxL = 128;
constexpr int kTile = 64;  // long route: rows per streamed tile
constexpr int kLongThreads = kTile / 16 * 32;
// Blocks per SM the long-route kernels ask registers for at DP <= 16: five
// (<= 102 registers) rather than the four that 116-123 registers allow.
// Worth ~5% at L 1001, Dh 9 (BST at history 1,000), as is the k = 4 tail
// (PERF.md).
constexpr int kLongMinBlocksNarrow = 5;
constexpr int64_t kMaxSmem = 232448;  // the most shared memory one block may use

// Row stride of the fused route's dS^T: >= L, and 8 mod 16 so that the
// transposed A reads of one warp hit 32 different banks.
__host__ __device__ constexpr int fused_lds(int L) { return (L + 15) / 16 * 16 + 8; }

// Floats of one tensor's span of n in the fused route: rounded up to 16
// bytes, then 16 zeros. B reads of the last row reach DP - Dh <= 15 floats
// past its Dh, and meet only these zeros.
__host__ __device__ constexpr int fused_span(int n) { return (n + 3) / 4 * 4 + 16; }

// q, k, v, dO spans, dS^T [L][fused_lds], lse and di [H][L], seg [L].
// Mirrored by ops/flash_attention.py.
int64_t fused_smem_bytes(int L, int H, int Dh) {
  return 4 * (4LL * fused_span(L * H * Dh) + (int64_t)L * fused_lds(L) + 2LL * H * L + L);
}

// ------------------------------------------------------------ copies
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ 3xTF32 mma
// x = hi + lo: hi is x rounded to TF32's 10 mantissa bits (round half away
// from zero on the bits), lo = x - hi exactly. lo is passed as it is: the
// tensor core reads the top 19 bits of a TF32 operand, so lo loses at most
// 2^-10 of itself, i.e. 2^-21 of x (the 3xTF32 "fast" split of CUTLASS).
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same with k = 4: A's columns t (a[0], a[1]) and B's row t (b[0]) of
// the k = 8 fragments.
__device__ __forceinline__ void mma_k4(float (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b[0]));
}

// c += a b at f32 accuracy: the small products first, then hi * hi.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma(c, a.lo, b.hi);
  mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}

// The same product for a short sum over k: the three products go to three
// accumulators, so that three dependent chains run side by side
// (Acc3::sum adds them up at the end).
struct Acc3 {
  float hh[4], lh[4], hl[4];
  __device__ __forceinline__ Acc3() {
#pragma unroll
    for (int e = 0; e < 4; ++e) hh[e] = lh[e] = hl[e] = 0.f;
  }
  __device__ __forceinline__ void add(const FragA& a, const FragB& b) {
    mma(lh, a.lo, b.hi);
    mma(hl, a.hi, b.lo);
    mma(hh, a.hi, b.hi);
  }
  // only the first 4 of the 8 columns of k: where Dh ends there
  __device__ __forceinline__ void add_k4(const FragA& a, const FragB& b) {
    mma_k4(lh, a.lo, b.hi);
    mma_k4(hl, a.hi, b.lo);
    mma_k4(hh, a.hi, b.hi);
  }
  __device__ __forceinline__ float sum(int e) const { return hh[e] + (lh[e] + hl[e]); }
};

// ------------------------------------------------------------ fragments
// Rows of one head in shared memory: element (r, c) at p[r * stride + c].
// operator() reads 0 outside [0, rows) x [0, cols): A fragments, which pad
// L and Dh with zeros. at() clamps the row into [0, rows) and reads any
// column below the padded width DP: B fragments, whose padding only meets
// zeros of the A side or is masked. Columns [Dh, DP) hold the next head's
// or row's inputs, the fused span's zero tail, or the long tiles' zeroed
// pad columns: never uninitialised memory.
struct View {
  const float* p;
  int stride, rows, cols;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return r < rows && c < cols ? p[r * stride + c] : 0.f;
  }
  __device__ __forceinline__ float at(int r, int c) const {
    return p[min(r, rows - 1) * stride + c];
  }
};

// groupID and threadID_in_group of the PTX ISA's fragment layouts: an A
// fragment (16 x 8) holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); a B
// fragment (8 x 8) holds (k = t, n = g), (t + 4, g); an accumulator (16 x 8)
// holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
struct Lane {
  int g, t;
};

__device__ __forceinline__ Lane lane() {
  const int l = threadIdx.x & 31;
  return {l >> 2, l & 3};
}

// A[m][k] = X(r0 + m, c0 + k)
__device__ __forceinline__ FragA load_a(const View& x, int r0, int c0, Lane l) {
  return split_a(x(r0 + l.g, c0 + l.t), x(r0 + l.g + 8, c0 + l.t),
                 x(r0 + l.g, c0 + l.t + 4), x(r0 + l.g + 8, c0 + l.t + 4));
}

// A[m][k] = X(r0 + k, c0 + m)
__device__ __forceinline__ FragA load_at(const View& x, int r0, int c0, Lane l) {
  return split_a(x(r0 + l.t, c0 + l.g), x(r0 + l.t, c0 + l.g + 8),
                 x(r0 + l.t + 4, c0 + l.g), x(r0 + l.t + 4, c0 + l.g + 8));
}

// B[k][n] = X(r0 + k, c0 + n)
__device__ __forceinline__ FragB load_b(const View& x, int r0, int c0, Lane l) {
  return split_b(x.at(r0 + l.t, c0 + l.g), x.at(r0 + l.t + 4, c0 + l.g));
}

// B[k][n] = X(r0 + n, c0 + k): products with the rows of X
__device__ __forceinline__ FragB load_bt(const View& x, int r0, int c0, Lane l) {
  return split_b(x.at(r0 + l.g, c0 + l.t), x.at(r0 + l.g, c0 + l.t + 4));
}

// An accumulator as the A operand of the next product. A lane holds columns
// 2t and 2t + 1 of its rows where an A fragment wants columns t and t + 4; a
// product sums over k in any order, so k = t stands for column 2t and
// k = t + 4 for column 2t + 1, and the B operand is read in that order
// (load_b_acc). No shuffle is needed.
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// B[k][n] = X(r0 + k', c0 + n), k' the column order of acc_as_a
__device__ __forceinline__ FragB load_b_acc(const View& x, int r0, int c0, Lane l) {
  return split_b(x.at(r0 + 2 * l.t, c0 + l.g), x.at(r0 + 2 * l.t + 1, c0 + l.g));
}

// A warp's own rows as A fragments, one per 8 columns: split once where the
// registers allow it (DP <= 32), else kept in f32 and split at each use.
template <bool kSplit>
struct ARows;

template <>
struct ARows<true> {
  FragA f;
  __device__ __forceinline__ void set(const View& x, int r0, int c0, Lane l) {
    f = load_a(x, r0, c0, l);
  }
  __device__ __forceinline__ FragA get() const { return f; }
};

template <>
struct ARows<false> {
  float x[4];
  __device__ __forceinline__ void set(const View& v, int r0, int c0, Lane l) {
    x[0] = v(r0 + l.g, c0 + l.t);
    x[1] = v(r0 + l.g + 8, c0 + l.t);
    x[2] = v(r0 + l.g, c0 + l.t + 4);
    x[3] = v(r0 + l.g + 8, c0 + l.t + 4);
  }
  __device__ __forceinline__ FragA get() const { return split_a(x[0], x[1], x[2], x[3]); }
};

// The 16 rows a warp owns from row r0: A fragments of two tensors (k and v,
// or q and dO), and the seg and liveness of the lane's rows g and g + 8.
template <int DP>
struct Own {
  ARows<DP <= 32> x[DP / 8], y[DP / 8];
  int seg[2];
  bool ok[2];

  __device__ __forceinline__ void load(const View& xv, const View& yv, const int* segs,
                                       int r0, int n, Lane l) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      x[kk].set(xv, r0, 8 * kk, l);
      y[kk].set(yv, r0, 8 * kk, l);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + l.g + 8 * r;
      ok[r] = row < n;
      seg[r] = ok[r] ? segs[row] : 0;
    }
  }
};

template <int DP>
using Acc = float[DP / 8][4];

// The other side's 8 rows at j0 as the lane's accumulator columns 2t and
// 2t + 1, and whether the 16 x 8 tile holds a visible pair at all. A tile
// without one adds exact zeros, so the warp skips it: with BST's padded
// histories (~75% valid, valid positions first) ~37% of pairs are masked.
struct Cols {
  int seg[2];
  bool ok[2];
  bool live;  // the same in every lane of the warp
};

template <int DP>
__device__ __forceinline__ Cols cols(const Own<DP>& own, const int* seg, int n, int j0,
                                     Lane l) {
  Cols c;
  bool any = false;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = j0 + 2 * l.t + i;
    c.ok[i] = j < n;
    c.seg[i] = seg[min(j, n - 1)];
#pragma unroll
    for (int r = 0; r < 2; ++r) any |= own.ok[r] && c.ok[i] && c.seg[i] == own.seg[r];
  }
  c.live = __any_sync(0xffffffffu, any);
  return c;
}

// s += X Y^T and dp += Z W^T over the head dim, X and Z the warp's own rows
// (Own), Y and W 8 rows of the other side at r0. With kTail4 the last 8
// columns hold at most 4 of Dh (Dh % 8 in 1..4), and a k = 4 product does them.
template <int DP, bool kTail4>
__device__ __forceinline__ void head_products(const Own<DP>& own, const View& y,
                                              const View& w, int r0, Lane l, Acc3& s,
                                              Acc3& dp) {
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const FragB by = load_bt(y, r0, 8 * kk, l), bw = load_bt(w, r0, 8 * kk, l);
    if (kTail4 && kk == DP / 8 - 1) {
      s.add_k4(own.x[kk].get(), by);
      dp.add_k4(own.y[kk].get(), bw);
    } else {
      s.add(own.x[kk].get(), by);
      dp.add(own.y[kk].get(), bw);
    }
  }
}

// ------------------------------------------------------------ the two steps
// Key side, one step of 8 queries at j0: S^T and dP^T of the warp's keys
// against the queries, then P^T and dS^T, then dV += P^T dO and
// dK += dS^T Q (dK unscaled). lse2 (lse * log2 e), di and seg are indexed by
// the query rows of the views; ds returns dS^T in the accumulator layout.
template <int DP, bool kTail4>
__device__ __forceinline__ void dkv_step(const Own<DP>& kv, const View& q, const View& dout,
                                         const float* lse2, const float* di, const int* seg,
                                         int nq, int j0, float c2, Lane l, Acc<DP>& dk,
                                         Acc<DP>& dv, float (&ds)[4]) {
  const Cols c = cols(kv, seg, nq, j0, l);
  if (!c.live) {
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[e] = 0.f;
    return;
  }
  Acc3 s, dp;
  head_products<DP, kTail4>(kv, q, dout, j0, l, s, dp);
  float p[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = e >> 1, i = e & 1, j = min(j0 + 2 * l.t + i, nq - 1);
    const bool on = kv.ok[r] && c.ok[i] && c.seg[i] == kv.seg[r];
    p[e] = on ? exp2f(fmaf(s.sum(e), c2, -lse2[j])) : 0.f;
    ds[e] = on ? p[e] * (dp.sum(e) - di[j]) : 0.f;
  }
  const FragA pa = acc_as_a(p), da = acc_as_a(ds);
#pragma unroll
  for (int nn = 0; nn < DP / 8; ++nn) {
    mma3(dv[nn], pa, load_b_acc(dout, j0, 8 * nn, l));
    mma3(dk[nn], da, load_b_acc(q, j0, 8 * nn, l));
  }
}

// Query side, one step of 8 keys at k0: S and dP of the warp's queries, then
// dS, then dQ += dS K (unscaled). lse2 and di are the lane's rows'.
template <int DP, bool kTail4>
__device__ __forceinline__ void dq_step(const Own<DP>& qd, const float (&lse2)[2],
                                        const float (&di)[2], const View& k, const View& v,
                                        const int* seg, int nk, int k0, float c2, Lane l,
                                        Acc<DP>& dq) {
  const Cols c = cols(qd, seg, nk, k0, l);
  if (!c.live) return;
  Acc3 s, dp;
  head_products<DP, kTail4>(qd, k, v, k0, l, s, dp);
  float ds[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = e >> 1, i = e & 1;
    const bool on = qd.ok[r] && c.ok[i] && c.seg[i] == qd.seg[r];
    ds[e] = on ? exp2f(fmaf(s.sum(e), c2, -lse2[r])) * (dp.sum(e) - di[r]) : 0.f;
  }
  const FragA da = acc_as_a(ds);
#pragma unroll
  for (int nn = 0; nn < DP / 8; ++nn) mma3(dq[nn], da, load_b_acc(k, k0, 8 * nn, l));
}

// acc rows row0 .. row0 + 15 times mul into out[base + row * HD + col], for
// rows < L and columns < Dh.
template <int DP>
__device__ __forceinline__ void store_acc(float* __restrict__ out, int64_t base, int HD,
                                          int row0, int L, int Dh, const Acc<DP>& acc,
                                          float mul, Lane l) {
#pragma unroll
  for (int nn = 0; nn < DP / 8; ++nn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + l.g + 8 * (e >> 1), c = 8 * nn + 2 * l.t + (e & 1);
      if (r < L && c < Dh) out[base + (int64_t)r * HD + c] = acc[nn][e] * mul;
    }
  }
}

template <int DP>
__device__ __forceinline__ void zero(Acc<DP>& acc) {
#pragma unroll
  for (int nn = 0; nn < DP / 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;
}

// ------------------------------------------------------------ fused route
// One block per batch row b, one warp per 16 rows (L rounded up to 16); the
// heads one after the other. Per head: each warp takes 16 keys and streams
// the queries in steps of 8 (dK, dV, and dS^T into shared memory), then,
// after a barrier, 16 queries, streaming dS^T and K in steps of 8 keys (dQ).
template <int DP, bool kTail4>
__global__ void __launch_bounds__(kFusedMaxL / 16 * 32, DP <= 16 ? 2 : 1)
flash_bwd_fused_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const int* __restrict__ seg,
                       const float* __restrict__ o, const float* __restrict__ dout,
                       const float* __restrict__ lse, float* __restrict__ dq,
                       float* __restrict__ dk, float* __restrict__ dv, int L, int H,
                       int Dh, float scale, bool vec) {
  extern __shared__ float4 smem[];
  const int HD = H * Dh, n = L * HD, n4 = fused_span(n), lds = fused_lds(L);
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + n4;
  float* vs = ks + n4;
  float* dos = vs + n4;
  float* dst = dos + n4;         // dS^T of one head, [L keys][lds]
  float* lse_s = dst + L * lds;  // [H][L], times log2 e
  float* di_s = lse_s + H * L;   // [H][L]
  int* seg_s = reinterpret_cast<int*>(di_s + H * L);
  const int b = blockIdx.x, tid = threadIdx.x, nthreads = blockDim.x;
  const int64_t base = (int64_t)b * n;

  const float* src[4] = {q + base, k + base, v + base, dout + base};
  float* to[4] = {qs, ks, vs, dos};
  if (vec) {
    for (int e = tid; e < n / 4; e += nthreads)
#pragma unroll
      for (int m = 0; m < 4; ++m) cp_async16(to[m] + 4 * e, src[m] + 4 * e);
  } else {
    for (int e = tid; e < n; e += nthreads)
#pragma unroll
      for (int m = 0; m < 4; ++m) cp_async4(to[m] + e, src[m] + e);
  }
  for (int e = tid; e < L; e += nthreads) cp_async4(seg_s + e, seg + (int64_t)b * L + e);
  cp_async_commit();
  for (int e = n + tid; e < n4; e += nthreads)  // B reads past the last row's Dh
#pragma unroll
    for (int m = 0; m < 4; ++m) to[m][e] = 0.f;
  for (int e = tid; e < H * L; e += nthreads) lse_s[e] = lse[(int64_t)b * H * L + e] * kLog2e;
  cp_async_wait<0>();
  __syncthreads();
  // di = rowsum(dO * O): entry e = l * H + h is the e-th Dh-piece of the span
  for (int e = tid; e < L * H; e += nthreads) {
    const float* orow = o + base + (int64_t)e * Dh;
    const float* drow = dos + e * Dh;
    float s = 0.f;
    for (int d = 0; d < Dh; ++d) s = fmaf(drow[d], orow[d], s);
    di_s[(e % H) * L + e / H] = s;
  }
  __syncthreads();

  const Lane l = lane();
  const int r0 = 16 * (tid >> 5);
  const float c2 = scale * kLog2e;
  for (int h = 0; h < H; ++h) {
    const View qv{qs + h * Dh, HD, L, Dh}, kv{ks + h * Dh, HD, L, Dh};
    const View vv{vs + h * Dh, HD, L, Dh}, dov{dos + h * Dh, HD, L, Dh};
    const int64_t obase = base + (int64_t)h * Dh;
    Own<DP> own;
    {  // the warp's keys
      own.load(kv, vv, seg_s, r0, L, l);
      Acc<DP> dka, dva;
      zero<DP>(dka);
      zero<DP>(dva);
      for (int j0 = 0; j0 < L; j0 += 8) {
        float ds[4];
        dkv_step<DP, kTail4>(own, qv, dov, lse_s + h * L, di_s + h * L, seg_s, L, j0, c2, l, dka,
                     dva, ds);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + l.g + 8 * (e >> 1), j = j0 + 2 * l.t + (e & 1);
          if (row < L && j < L) dst[row * lds + j] = ds[e];
        }
      }
      store_acc<DP>(dk, obase, HD, r0, L, Dh, dka, scale, l);
      store_acc<DP>(dv, obase, HD, r0, L, Dh, dva, 1.f, l);
    }
    __syncthreads();
    {  // the warp's queries: dQ = scale dS K, skipping key steps without a visible pair
      const View dsv{dst, lds, L, L};  // (key, query)
      const int qseg0 = seg_s[min(r0 + l.g, L - 1)], qseg1 = seg_s[min(r0 + l.g + 8, L - 1)];
      Acc<DP> dqa;
      zero<DP>(dqa);
      for (int k0 = 0; k0 < L; k0 += 8) {
        bool any = false;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int j = k0 + l.t + 4 * i;
          const int kseg = seg_s[min(j, L - 1)];
          any |= j < L && (kseg == qseg0 || kseg == qseg1);
        }
        if (!__any_sync(0xffffffffu, any)) continue;
        const FragA a = load_at(dsv, k0, r0, l);
#pragma unroll
        for (int nn = 0; nn < DP / 8; ++nn) mma3(dqa[nn], a, load_b(kv, k0, 8 * nn, l));
      }
      store_acc<DP>(dq, obase, HD, r0, L, Dh, dqa, scale, l);
    }
    __syncthreads();  // before the next head's dS^T
  }
}

// ------------------------------------------------------------ long route
// Rows [row0, row0 + n) of one head of a [B, L, H, Dh] tensor (base is the
// offset of (b, 0, h, 0)) into dst[r * RS + c], c < Dh, by cp.async.
template <int RS>
__device__ __forceinline__ void load_tile_async(float* dst, const float* __restrict__ x,
                                                int64_t base, int row0, int n, int HD,
                                                int Dh, bool vec, int tid) {
  if (vec) {
    const int cpr = Dh >> 2;
    for (int e = tid; e < n * cpr; e += kLongThreads) {
      const int r = e / cpr, c = (e - r * cpr) << 2;
      cp_async16(dst + r * RS + c, x + base + (int64_t)(row0 + r) * HD + c);
    }
  } else {
    for (int e = tid; e < n * Dh; e += kLongThreads) {
      const int r = e / Dh, c = e - r * Dh;
      cp_async4(dst + r * RS + c, x + base + (int64_t)(row0 + r) * HD + c);
    }
  }
}

// Shared memory of a long-route block: its own two tiles and the two
// streamed ones double-buffered, [kTile][RS] each, and three row vectors
// [2][kTile].
template <int DP>
struct Long {
  static constexpr int kRs = DP + 4;  // 4 mod 8: A and B reads hit 32 banks
  static constexpr int kTileFloats = kTile * kRs;
  static constexpr int64_t kBytes = 4 * (6LL * kTileFloats + 6LL * kTile);
};

// Columns [Dh, DP) of a long-route block's six tiles, which the copies never
// write and B reads meet.
template <int DP>
__device__ __forceinline__ void zero_pad_columns(float* tiles, int Dh, int tid) {
  const int w = DP - Dh;
  for (int e = tid; e < 6 * kTile * w; e += kLongThreads) {
    const int r = e / w;
    tiles[r * Long<DP>::kRs + Dh + (e - r * w)] = 0.f;
  }
}

// blockIdx.x = (b * tiles + tile) * H + h, as the forward.
struct Where {
  int b, h, row0;
  int64_t base;  // offset of (b, 0, h, 0) in a [B, L, H, Dh] tensor
  int64_t rows;  // offset of (b, h, 0) in a [B, H, L] tensor
};

__device__ __forceinline__ Where where(int L, int H, int Dh) {
  const int tiles = (L + kTile - 1) / kTile;
  int blk = blockIdx.x;
  Where w;
  w.h = blk % H;
  blk /= H;
  w.row0 = (blk % tiles) * kTile;
  w.b = blk / tiles;
  w.base = (int64_t)w.b * L * H * Dh + (int64_t)w.h * Dh;
  w.rows = ((int64_t)w.b * H + w.h) * L;
  return w;
}

// dK, dV of the block's 64 keys; the queries stream through in tiles of 64.
template <int DP, bool kTail4>
__global__ void __launch_bounds__(kLongThreads, DP <= 16 ? kLongMinBlocksNarrow : 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, float* __restrict__ dk,
                     float* __restrict__ dv, int L, int H, int Dh, float scale, bool vec) {
  constexpr int RS = Long<DP>::kRs, TF = Long<DP>::kTileFloats;
  extern __shared__ float4 smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + TF;
  float* qs = vs + TF;  // [2][kTile][RS]
  float* dos = qs + 2 * TF;
  float* lse_s = dos + 2 * TF;  // [2][kTile]
  float* di_s = lse_s + 2 * kTile;
  int* seg_s = reinterpret_cast<int*>(di_s + 2 * kTile);
  const Where w = where(L, H, Dh);
  const int HD = H * Dh, tid = threadIdx.x, r0 = 16 * (tid >> 5);
  const int kn = min(kTile, L - w.row0);
  const int nt = (L + kTile - 1) / kTile;
  const Lane l = lane();

  zero_pad_columns<DP>(reinterpret_cast<float*>(smem), Dh, tid);
  load_tile_async<RS>(ks, k, w.base, w.row0, kn, HD, Dh, vec, tid);
  load_tile_async<RS>(vs, v, w.base, w.row0, kn, HD, Dh, vec, tid);
  auto prefetch = [&](int t) {
    const int buf = t & 1, q0 = t * kTile, n = min(kTile, L - q0);
    load_tile_async<RS>(qs + buf * TF, q, w.base, q0, n, HD, Dh, vec, tid);
    load_tile_async<RS>(dos + buf * TF, dout, w.base, q0, n, HD, Dh, vec, tid);
    for (int e = tid; e < n; e += kLongThreads) {
      cp_async4(lse_s + buf * kTile + e, lse + w.rows + q0 + e);
      cp_async4(di_s + buf * kTile + e, di + w.rows + q0 + e);
      cp_async4(seg_s + buf * kTile + e, seg + (int64_t)w.b * L + q0 + e);
    }
    cp_async_commit();
  };
  prefetch(0);  // one group with the block's own keys

  Own<DP> own;
  Acc<DP> dka, dva;
  zero<DP>(dka);
  zero<DP>(dva);
  const float c2 = scale * kLog2e;
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {
      prefetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = t & 1, n = min(kTile, L - t * kTile);
    float* lse2 = lse_s + buf * kTile;
    for (int e = tid; e < n; e += kLongThreads) lse2[e] *= kLog2e;
    if (t == 0)
      own.load(View{ks, RS, kn, Dh}, View{vs, RS, kn, Dh}, seg + (int64_t)w.b * L + w.row0,
               r0, kn, l);
    __syncthreads();
    if (r0 < kn) {
      const View qv{qs + buf * TF, RS, n, Dh}, dov{dos + buf * TF, RS, n, Dh};
      for (int j0 = 0; j0 < n; j0 += 8) {
        float ds[4];
        dkv_step<DP, kTail4>(own, qv, dov, lse2, di_s + buf * kTile, seg_s + buf * kTile, n, j0, c2,
                     l, dka, dva, ds);
      }
    }
    __syncthreads();  // before this buffer is loaded again
  }
  store_acc<DP>(dk, w.base, HD, w.row0 + r0, L, Dh, dka, scale, l);
  store_acc<DP>(dv, w.base, HD, w.row0 + r0, L, Dh, dva, 1.f, l);
}

// dQ of the block's 64 queries; the keys stream through in tiles of 64.
template <int DP, bool kTail4>
__global__ void __launch_bounds__(kLongThreads, DP <= 16 ? kLongMinBlocksNarrow : 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ seg,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq, int L, int H,
                    int Dh, float scale, bool vec) {
  constexpr int RS = Long<DP>::kRs, TF = Long<DP>::kTileFloats;
  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + TF;
  float* ks = dos + TF;  // [2][kTile][RS]
  float* vs = ks + 2 * TF;
  int* seg_s = reinterpret_cast<int*>(vs + 2 * TF);  // [2][kTile]
  const Where w = where(L, H, Dh);
  const int HD = H * Dh, tid = threadIdx.x, r0 = 16 * (tid >> 5);
  const int qn = min(kTile, L - w.row0);
  const int nt = (L + kTile - 1) / kTile;
  const Lane l = lane();

  zero_pad_columns<DP>(reinterpret_cast<float*>(smem), Dh, tid);
  load_tile_async<RS>(qs, q, w.base, w.row0, qn, HD, Dh, vec, tid);
  load_tile_async<RS>(dos, dout, w.base, w.row0, qn, HD, Dh, vec, tid);
  auto prefetch = [&](int t) {
    const int buf = t & 1, k0 = t * kTile, n = min(kTile, L - k0);
    load_tile_async<RS>(ks + buf * TF, k, w.base, k0, n, HD, Dh, vec, tid);
    load_tile_async<RS>(vs + buf * TF, v, w.base, k0, n, HD, Dh, vec, tid);
    for (int e = tid; e < n; e += kLongThreads)
      cp_async4(seg_s + buf * kTile + e, seg + (int64_t)w.b * L + k0 + e);
    cp_async_commit();
  };
  prefetch(0);  // one group with the block's own queries
  float lse2[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(w.row0 + r0 + l.g + 8 * r, L - 1);
    lse2[r] = lse[w.rows + row] * kLog2e;
    di_r[r] = di[w.rows + row];
  }

  Own<DP> own;
  Acc<DP> dqa;
  zero<DP>(dqa);
  const float c2 = scale * kLog2e;
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {
      prefetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0)
      own.load(View{qs, RS, qn, Dh}, View{dos, RS, qn, Dh}, seg + (int64_t)w.b * L + w.row0,
               r0, qn, l);
    const int buf = t & 1, n = min(kTile, L - t * kTile);
    if (r0 < qn) {
      const View kv{ks + buf * TF, RS, n, Dh}, vv{vs + buf * TF, RS, n, Dh};
      for (int k0 = 0; k0 < n; k0 += 8)
        dq_step<DP, kTail4>(own, lse2, di_r, kv, vv, seg_s + buf * kTile, n, k0, c2, l, dqa);
    }
    __syncthreads();  // before this buffer is loaded again
  }
  store_acc<DP>(dq, w.base, HD, w.row0 + r0, L, Dh, dqa, scale, l);
}

// ------------------------------------------------------------ host side
struct Args {
  const float *q, *k, *v;
  const int* seg;
  const float *o, *dout, *lse, *di;
  float *dq, *dk, *dv;
  int B, L, H, Dh;
  float scale;
};

enum Which { kFused, kDkv, kDq };

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename Kernel, typename... Ts>
void launch_kernel(Kernel kernel, unsigned grid, int threads, int64_t smem,
                   cudaStream_t stream, Ts... args) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  kernel<<<grid, threads, smem, stream>>>(args...);
}

template <int DP, bool kTail4>
void launch(Which which, const Args& a, cudaStream_t s) {
  const bool vec4 = aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.dout);
  if (which == kFused) {
    const bool vec = vec4 && ((int64_t)a.L * a.H * a.Dh) % 4 == 0;
    const int threads = (a.L + 15) / 16 * 32;
    launch_kernel(flash_bwd_fused_kernel<DP, kTail4>, (unsigned)a.B, threads,
                  fused_smem_bytes(a.L, a.H, a.Dh), s, a.q, a.k, a.v, a.seg, a.o, a.dout,
                  a.lse, a.dq, a.dk, a.dv, a.L, a.H, a.Dh, a.scale, vec);
    return;
  }
  const bool vec = vec4 && a.Dh % 4 == 0;
  const unsigned grid = (unsigned)((int64_t)a.B * ((a.L + kTile - 1) / kTile) * a.H);
  if (which == kDkv)
    launch_kernel(flash_bwd_dkv_kernel<DP, kTail4>, grid, kLongThreads, Long<DP>::kBytes, s, a.q,
                  a.k, a.v, a.seg, a.dout, a.lse, a.di, a.dk, a.dv, a.L, a.H, a.Dh, a.scale,
                  vec);
  else
    launch_kernel(flash_bwd_dq_kernel<DP, kTail4>, grid, kLongThreads, Long<DP>::kBytes, s, a.q,
                  a.k, a.v, a.seg, a.dout, a.lse, a.di, a.dq, a.L, a.H, a.Dh, a.scale, vec);
}

int dispatch(Which which, const Args& a, void* stream) {
  if (a.B <= 0 || a.L <= 0 || a.H <= 0 || a.Dh <= 0 || a.Dh > 64 ||
      (int64_t)a.B * ((a.L + kTile - 1) / kTile) * a.H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (which == kFused &&
      (a.L > kFusedMaxL || fused_smem_bytes(a.L, a.H, a.Dh) > kMaxSmem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.Dh <= 4)
    launch<8, true>(which, a, s);
  else if (a.Dh <= 8)
    launch<8, false>(which, a, s);
  else if (a.Dh <= 12)
    launch<16, true>(which, a, s);
  else if (a.Dh <= 16)
    launch<16, false>(which, a, s);
  else if (a.Dh <= 24)
    launch<24, false>(which, a, s);
  else if (a.Dh <= 32)
    launch<32, false>(which, a, s);
  else if (a.Dh <= 48)
    launch<48, false>(which, a, s);
  else
    launch<64, false>(which, a, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the fused route needs for one batch row (as bwd_route counts it).
extern "C" long long rtt_flash_attention_bwd_fused_smem(int L, int H, int Dh) {
  return fused_smem_bytes(L, H, Dh);
}

// Fused route: dQ, dK, dV [B, L, H, Dh] from q, k, v, seg, o, dO and lse.
extern "C" int rtt_flash_attention_bwd_fused(const void* q, const void* k, const void* v,
                                             const void* seg, const void* o,
                                             const void* dout, const void* lse, void* dq,
                                             void* dk, void* dv, int B, int L, int H,
                                             int Dh, float scale, void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.seg = static_cast<const int*>(seg);
  a.o = static_cast<const float*>(o);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.B = B; a.L = L; a.H = H; a.Dh = Dh; a.scale = scale;
  return dispatch(kFused, a, stream);
}

// Long route: dK, dV from q, k, v, seg, dO, lse and di = rowsum(dO * O) [B, H, L].
extern "C" int rtt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* seg, const void* dout,
                                           const void* lse, const void* di,
                                           void* dk, void* dv, int B, int L,
                                           int H, int Dh, float scale,
                                           void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.seg = static_cast<const int*>(seg);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.B = B; a.L = L; a.H = H; a.Dh = Dh; a.scale = scale;
  return dispatch(kDkv, a, stream);
}

// Long route: dQ from the same inputs.
extern "C" int rtt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* seg, const void* dout,
                                          const void* lse, const void* di,
                                          void* dq, int B, int L, int H, int Dh,
                                          float scale, void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.seg = static_cast<const int*>(seg);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.dq = static_cast<float*>(dq);
  a.B = B; a.L = L; a.H = H; a.Dh = Dh; a.scale = scale;
  return dispatch(kDq, a, stream);
}
