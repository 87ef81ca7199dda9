// Flash attention backward with a segment-id mask, at any head dim, on the
// tensor cores at f32 accuracy.
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
// * fused (L <= 128 and fused_smem_bytes(L, H, Dh) <= 227 KB, which every
//   Dh > 64 meets; BST's B1024 L101 H4 Dh9 takes it): one block per batch
//   row b (above Dh 64, per batch row and head) replaces both TPU kernels.
//   It computes di itself, and for each head S, P, dP and dS once.
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
// They run at 9-23% of these bounds (times: PERF.md, from chip_smoke.py
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
// 6. Head dims above 64 (flash_mma.cuh, "Head dims"): a warp's own rows and
//    its dK, dV accumulators at the whole Dh would not fit its registers, nor
//    the long tiles shared memory, so a wide Dh runs in chunks of 64 columns.
//    The wide fused kernel ("wide fused route" below) replaces, at L <= 128,
//    both TPU kernels. Its bound on an H100 (chip_smoke.py's k2_bounds, the
//    `bwd` row: q, k, v, o, dO, dq, dk, dv, lse, seg once at 3.35 TB/s):
//    0.071 ms at BST's rows b1024 L101 with one head of Dh 72, 0.127 ms at
//    Dh 128 and at b256 L101 H2 Dh256, each set by bytes (the 3xTF32
//    products of the kept pairs take less). The chunked kernel before it
//    had two faults, and the design answers each:
//    - It computed S^T and dP^T again over every column for each 64-column
//      chunk of dK and dV: 7 L^2 Dh products at two chunks where 5 do. Now
//      a warp adds S^T and dP^T of its 16 keys against every query up over
//      the whole Dh, chunk by chunk, keeps them in registers (128 floats a
//      lane: L <= 128), turns them into P^T and dS^T in place, and makes
//      dV, dK and (from dS^T in shared memory) dQ one chunk at a time.
//    - Its block held the whole [L, H, Dh] spans of q, k, v and dO, so its
//      shared memory grew with Dh: 166 KB at H 1, Dh 72 and L 101, and past
//      227 KB from Dh 113, where the route went long (1.6x the pairs at L
//      101: 64-row tiles, and S and dP in each of two kernels). Now a block
//      is one (batch row, head) and streams the 64-column chunks of q, k, v
//      and dO through a ring of unpadded swizzled [Lp, 64] slots (Lp: L
//      rounded up to 16) with copies in flight; its shared memory follows L
//      alone (220 KB at L 101, 196 KB at 128: one block an SM), so the
//      fused route takes every Dh at L <= 128.
//    Its 14-16 warps (two per 16 rows, at most 128 registers) split each
//    pass's tiles or output columns. Measured on an NVIDIA H100 80GB HBM3
//    at 700 W (chip_smoke.py --k2): 0.59 ms
//    at Dh 128 (the long pair on the same inputs 1.20, SDPA's backward
//    0.93), 0.47-0.48 at Dh 72 (the chunked kernel 0.62-0.63), 0.57-0.58
//    at Dh 256 (long pair 1.55), 15-22% of its bounds; 128 registers, no
//    local memory. k2_bwd_variants.py's diagnostic builds split the time at
//    Dh 128 into the sums of S^T and dP^T (~0.19 ms), dV, dK and dQ (~0.27)
//    and the copies, barriers, di and lists around them (~0.17), which the
//    products do not hide.
//    The long route ("wide long route" below) gives a
//    block 64 rows and a group of up to 4 chunks (256 columns) of their
//    outputs, and computes S and dP once per streamed tile over the whole Dh
//    (the chunked kernels before it did so once per output chunk: 2x the
//    products at Dh 128, 3x at 256): phase A adds them up chunk by chunk from
//    a ring of copies in flight (the next tile's, or the next chunk's, load
//    while this one multiplies), phase B makes the group's outputs from P and
//    D = dP - di in shared memory. Its 64-column tiles carry no pad (an XOR
//    swizzle spreads the reads over the banks), so a block holds two own
//    chunks and four streamed ones (231 KB); copies fill every row and column
//    outside the inputs with zeros, so the products read without bounds.
//    Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py --k2):
//    the L1001 probe at Dh 128, H 4: dK/dV 14.9 ms and dQ 12.4 ms alone
//    (the chunked kernels: 18.7 and 14.6), 15% and 13% of their 2.17 and
//    1.63 ms (operations) bounds; BST's rows with one head of Dh 128: 0.61
//    and 0.51 ms (0.69, 0.54), 16% of their (bytes) bounds; Dh 256, B 256,
//    H 2: 0.86 and 0.64 ms (1.15, 0.93), 11% and 12%. The 3xTF32 mma.sync
//    products of the two phases take most of it, and the barriers between
//    them, where none runs, the rest. cudaFuncGetAttributes (the same card):
//    dK/dV 126 registers and dQ 108 with 16 warps, 246 and 191 with 8, no
//    local memory, one block an SM.
// Each output element is written once, by one lane, with no atomics: every
// launch is bitwise deterministic.
//
// C interface for ctypes: pointers and the stream as void*; each entry
// returns cudaGetLastError() after its launch (cudaErrorInvalidValue for a
// shape it does not take).

#include "flash_mma.cuh"

namespace {

// Blocks per SM the long-route kernels ask registers for at DP <= 16: five
// (<= 102 registers) rather than the four that 116-123 registers allow.
// Worth ~5% at L 1001, Dh 9 (BST at history 1,000), as is the k = 4 tail
// (PERF.md).
constexpr int kLongMinBlocksNarrow = 5;

// Row stride of the fused route's dS^T: >= L, and 8 mod 16 so that the
// transposed A reads of one warp hit 32 different banks.
__host__ __device__ constexpr int fused_lds(int L) { return (L + 15) / 16 * 16 + 8; }

// q, k, v, dO spans, dS^T [L][fused_lds], lse and di [H][L], seg [L]; above
// Dh 64 the wide fused block's (wide_fused_smem_bytes, a function of L
// alone). Mirrored by ops/flash_attention.py.
int64_t narrow_fused_smem_bytes(int L, int H, int Dh) {
  return 4 * (4LL * fused_span(L * H * Dh) + (int64_t)L * fused_lds(L) + 2LL * H * L + L);
}

// The 16 rows a warp owns from row r0: A fragments of two tensors (k and v,
// or q and dO), and the seg and liveness of the lane's rows g and g + 8.
template <int DP>
struct Own : RowSeg {
  ARows<DP <= 32> x[DP / 8], y[DP / 8];

  __device__ __forceinline__ void load(const View& xv, const View& yv, const int* segs,
                                       int r0, int n, Lane l) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      x[kk].set(xv, r0, 8 * kk, l);
      y[kk].set(yv, r0, 8 * kk, l);
    }
    set(segs, r0, n, l);
  }
};

// The other side's 8 rows at j0 as the lane's accumulator columns 2t and
// 2t + 1, and whether the 16 x 8 tile holds a visible pair at all. A tile
// without one adds exact zeros, so the warp skips it: with BST's padded
// histories (~75% valid, valid positions first) ~37% of pairs are masked.
struct Cols {
  int seg[2];
  bool ok[2];
  bool live;  // the same in every lane of the warp
};

__device__ __forceinline__ Cols cols(const RowSeg& own, const int* seg, int n, int j0,
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

// P^T and dS^T of the key side's 16 x 8 tile at the queries j0 (the
// lane's entries), from the sums S^T (s) and dP^T (dp); lse2 (lse * log2 e),
// di and the visibility c are the queries'.
__device__ __forceinline__ void key_side_probs(const RowSeg& own, const Cols& c,
                                               const float (&s)[4], const float (&dp)[4],
                                               const float* lse2, const float* di, int nq,
                                               int j0, float c2, Lane l, float (&p)[4],
                                               float (&ds)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = e >> 1, i = e & 1, j = min(j0 + 2 * l.t + i, nq - 1);
    const bool on = own.ok[r] && c.ok[i] && c.seg[i] == own.seg[r];
    p[e] = on ? exp2f(fmaf(s[e], c2, -lse2[j])) : 0.f;
    ds[e] = on ? p[e] * (dp[e] - di[j]) : 0.f;
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
  float p[4], ss[4], dps[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ss[e] = s.sum(e);
    dps[e] = dp.sum(e);
  }
  key_side_probs(kv, c, ss, dps, lse2, di, nq, j0, c2, l, p, ds);
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

// ------------------------------------------------------------ fused route
// One block per batch row b, one warp per 16 rows (L rounded up to 16); the
// heads one after the other. Per head: each warp takes 16 keys and streams
// the queries in steps of 8 (dK, dV, and dS^T into shared memory), then,
// after a barrier, 16 queries, streaming dS^T and K in steps of 8 keys (dQ).
// Dh <= 64; a wider head takes the wide fused route below.
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

// ------------------------------------------------------------ wide fused route
// Dh > 64 and L <= kFusedMaxL: one block per (batch row b, head h), two warps
// per 16 rows (Lp: L rounded up to 16), a pair. The pair of rows r0 .. r0 +
// 15 owns them as keys (S^T, dP^T, dV, dK) and as queries (dQ).
// * Pass S, per chunk d (Q_d, K_d): S^T = K Q^T of the pair's keys against
//   every query, summed over the whole Dh; the pair splits the tiles of 8
//   queries. Then P^T into shared memory [Lp][lds] (the dS^T buffer).
// * Pass P, per chunk d (dO_d, V_d): dP^T = V dO^T, split as S^T; dV_d =
//   P^T dO_d, each warp of the pair 32 of the chunk's columns over every
//   tile. Then dS^T = P^T (dP^T - di) in place of P^T; di = rowsum(dO O)
//   comes from the block's first lines, 16 lanes a row, all loads at once.
// * Pass B, per chunk c (Q_c, K_c): dK_c = scale dS^T Q_c and dQ_c = scale
//   dS K_c (A read from dS^T by rows, or by columns), 32 columns a warp.
// So S and dP are computed once per (b, h): 5 L^2 Dh products. A warp keeps
// 32 floats of sums (8 tiles of its pair's 16), so a thread takes at most
// 128 registers and a block up to 16 warps.
//
// A pair lists the tiles of 8 queries (pass B, of 8 keys: the same numbers;
// the mask is symmetric) where its rows see a pair, 4 bits a tile number in
// `list`; warp `half` of the pair takes the tiles k % 2 == half (`mine`). The
// sums of S^T and dP^T run over `mine` in groups of 4 tiles, one branch a
// group (a tile there is one chain of three products; a branch per tile runs
// each chain alone, flash_attention.cu, "wide head dims"), the last group
// padded with the pair's first tile, whose sums no one reads. The outputs
// (4 chains a tile) loop over `list`, one tile an iteration.
//
// Shared memory, a function of L alone (wide_fused_smem_bytes): a ring of R
// slots, each one swizzled [Lp, 64] chunk tile (R = 6, 4 at Lp 128 where 6
// do not fit), P^T then dS^T [Lp][lds] (zero where no listed tile writes),
// lse * log2 e, di and seg [Lp]. Copies, in the order the steps take them:
// Q_d, K_d for every chunk, then dO_d, V_d, then Q_c, K_c; copy i goes to
// slot i % R. Each step takes two; it waits for them, then at one barrier,
// which also tells that every warp is done with the steps before and their
// slots, issues copies up to R past the last one read: R - 2 stay in flight
// under each step's products.
// Mirrored and simulated over Dh 65-599 and L 1-128 by
// tests/test_torch_flash_attention.py::test_wide_fused_bwd_ring_schedule.
constexpr int kFusedTiles = kFusedMaxL / 8;  // tiles of 8 rows a fused block holds
constexpr int kHalfTiles = kFusedTiles / 2;  // a warp's share of its pair's tiles
constexpr int kWideFusedSlots = 6;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// P^T's and dS^T's row stride: 4 mod 16, so that dQ's A reads (rows 2t and
// 2t + 1, columns g and g + 8) hit 32 banks.
__host__ __device__ constexpr int wide_fused_lds(int L) { return round16(L) + 4; }

// Floats of a wide fused block besides its ring: dS^T, lse2, di and seg.
__host__ __device__ constexpr int64_t wide_fused_rest(int L) {
  return (int64_t)round16(L) * wide_fused_lds(L) + 3LL * round16(L);
}

// Ring slots: kWideFusedSlots, or as many as fit kMaxSmem (4 at Lp 128).
__host__ __device__ constexpr int wide_fused_slots(int L) {
  const int64_t fit = (kMaxSmem / 4 - wide_fused_rest(L)) / ((int64_t)round16(L) * kC);
  return fit < kWideFusedSlots ? (int)fit : kWideFusedSlots;
}

// Mirrored by ops/flash_attention.py::fused_smem_bytes above Dh 64.
__host__ __device__ constexpr int64_t wide_fused_smem_bytes(int L) {
  return 4 * (wide_fused_rest(L) + (int64_t)wide_fused_slots(L) * round16(L) * kC);
}

// The first row of the k-th tile of a list (4 bits a tile number).
__device__ __forceinline__ int listed(uint64_t list, int k) {
  return 8 * (int)((list >> (4 * k)) & 15);
}

// x, as a value the compiler cannot see through: addresses computed from it
// are computed where they are used, not once for a whole loop and kept.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// acc[k] += X Y_k^T over one chunk of ks steps of 8 columns: X the pair's 16
// rows from r0 of a swizzled slot (A fragments), Y_k the 8 rows of the k-th
// tile of `mine` (B fragments), for the groups of 4 that hold its first nm.
// Rows r0 + g, r0 + g + 8 and every tile's row g swizzle by 4 g.
__device__ __forceinline__ void listed_score_products(const float* x, const float* y, int r0,
                                                      int ks, int nm, uint64_t mine, Lane l,
                                                      float (&acc)[kHalfTiles][4]) {
  mine = opaque(mine);
  const int sw = 4 * l.g, ra = (r0 + l.g) * kC;
#pragma unroll 2
  for (int kk = 0; kk < ks; ++kk) {
    const int c = (8 * kk + l.t) ^ sw, c4 = c ^ 4;
    const FragA a = split_a(x[ra + c], x[ra + 8 * kC + c], x[ra + c4], x[ra + 8 * kC + c4]);
#pragma unroll
    for (int gq = 0; gq < kHalfTiles / 4; ++gq) {
      if (4 * gq < nm) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* y0 = y + (listed(mine, 4 * gq + i) + l.g) * kC;
          mma3(acc[4 * gq + i], a, split_b(y0[c], y0[c4]));
        }
      }
    }
  }
}

// acc += A X over the first nl tiles of list (their 8 rows the sum's
// index), one tile an iteration: X a swizzled slot's rows of the tile,
// columns c0 + 8 nn + g (nn < NN), in load_b_acc's order (rows 2 t and 2 t +
// 1 swizzle by 8 t and 8 t + 4); A in the same order from d [.][lds]: its
// rows r0 + g and r0 + g + 8 at the tile's columns 2 t and 2 t + 1 (kRows),
// or the tile's rows 2 t and 2 t + 1 at columns r0 + g and r0 + g + 8.
template <int NN, bool kRows>
__device__ __forceinline__ void listed_out_products(const float* d, int lds, int r0,
                                                    const float* x, int c0, int nl,
                                                    uint64_t list, Lane l, float (&acc)[NN][4]) {
  list = opaque(list);
  const float* x0 = x + 2 * l.t * kC + l.g;
  const float* x1 = x + (2 * l.t + 1) * kC + (l.g ^ 4);
#pragma unroll 2
  for (int kq = 0; kq < nl; ++kq) {
    const int j0 = listed(list, kq);
    FragA f;
    if (kRows) {
      const float* a = d + (r0 + l.g) * lds + j0 + 2 * l.t;
      const float2 u = *reinterpret_cast<const float2*>(a);
      const float2 w = *reinterpret_cast<const float2*>(a + 8 * lds);
      f = split_a(u.x, w.x, u.y, w.y);
    } else {
      const float* a = d + (j0 + 2 * l.t) * lds + r0 + l.g;
      f = split_a(a[0], a[8], a[lds], a[lds + 8]);
    }
#pragma unroll
    for (int nn = 0; nn < NN; ++nn) {
      const int cc = j0 * kC + ((c0 + 8 * nn) ^ (8 * l.t));
      mma3(acc[nn], f, split_b(x0[cc], x1[cc]));
    }
  }
}

// The warp's 32 columns from c0 (those below the chunk's width wc) of one
// output chunk, times mul, into out at base (the chunk's first column).
template <bool kRows>
__device__ __forceinline__ void wide_fused_out(const float* d, int lds, int r0, const float* x,
                                               int c0, int nl, uint64_t list,
                                               float* __restrict__ out, int64_t base, int HD,
                                               int L, int wc, float mul, Lane l) {
  if (c0 >= wc) return;
  if (wc - c0 <= 16) {
    float acc[2][4] = {};
    listed_out_products<2, kRows>(d, lds, r0, x, c0, nl, list, l, acc);
    store_acc<16>(out, base + c0, HD, r0, L, wc - c0, acc, mul, l);
  } else {
    float acc[4][4] = {};
    listed_out_products<4, kRows>(d, lds, r0, x, c0, nl, list, l, acc);
    store_acc<32>(out, base + c0, HD, r0, L, wc - c0, acc, mul, l);
  }
}

__global__ void __launch_bounds__(2 * kFusedMaxL / 16 * 32, 1)
flash_bwd_fused_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const int* __restrict__ seg,
                            const float* __restrict__ o, const float* __restrict__ dout,
                            const float* __restrict__ lse, float* __restrict__ dq,
                            float* __restrict__ dk, float* __restrict__ dv, int L, int H,
                            int Dh, float scale, bool vec) {
  extern __shared__ float4 smem[];
  const int Lp = round16(L), R = wide_fused_slots(L), lds = wide_fused_lds(L);
  const int tile = Lp * kC;  // floats of a slot
  float* slots = reinterpret_cast<float*>(smem);
  float* dst = slots + R * tile;  // P^T, then dS^T [Lp][lds]: (key, query)
  float* lse2 = dst + Lp * lds;   // [Lp], times log2 e
  float* di_s = lse2 + Lp;        // [Lp]
  int* seg_s = reinterpret_cast<int*>(di_s + Lp);
  const int b = blockIdx.x / H, h = blockIdx.x - b * H, HD = H * Dh;
  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid >> 5, half = warp & 1;
  const int r0 = 16 * (warp >> 1), c0 = 32 * half;  // the pair's rows; the warp's output columns
  const int64_t base = (int64_t)b * L * HD + (int64_t)h * Dh;  // (b, 0, h, 0)
  const int64_t rows = ((int64_t)b * H + h) * L;               // (b, h, 0) of [B, H, L]
  const int nd = chunks(Dh), total = 6 * nd;
  const Lane l = lane();

  int issued = 0;
  auto issue = [&](int upto) {  // copy i: Q_d, K_d (pass S); dO_d, V_d (P); Q_c, K_c (B)
    for (; issued <= upto && issued < total; ++issued) {
      const int pass = issued / (2 * nd), d = (issued >> 1) - pass * nd;
      const float* x = pass == 1 ? (issued & 1 ? v : dout) : (issued & 1 ? k : q);
      // nthreads is a multiple of 64: whole rows of 4-byte copies too
      load_swz_async(slots + (issued % R) * tile, x, base + d * kC, 0, L, HD,
                     min(kC, Dh - d * kC), vec, tid, nthreads, Lp);
      cp_async_commit();
    }
  };
  issue(R - 1);
  for (int e = tid; e < Lp * lds; e += nthreads) dst[e] = 0.f;
  for (int e = tid; e < Lp; e += nthreads) {
    lse2[e] = e < L ? lse[rows + e] * kLog2e : 0.f;
    seg_s[e] = e < L ? seg[(int64_t)b * L + e] : 0;
  }
  {  // di = rowsum(dO * O): 16 lanes a row, 4 rows each (Lp / 4 groups), all loads in flight
    const int sub = tid & 15, group = tid >> 4;
    float sum[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = group + r * (Lp >> 2);
      const float* dr = dout + base + (int64_t)i * HD;
      const float* orow = o + base + (int64_t)i * HD;
      sum[r] = 0.f;
      if (i < L) {
        if (vec) {
#pragma unroll 2
          for (int c = 4 * sub; c < Dh; c += 64) {
            const float4 x = *reinterpret_cast<const float4*>(dr + c);
            const float4 y = *reinterpret_cast<const float4*>(orow + c);
            sum[r] += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
          }
        } else {
#pragma unroll 4
          for (int c = sub; c < Dh; c += 16) sum[r] = fmaf(dr[c], orow[c], sum[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
      if (sub == 0) di_s[group + r * (Lp >> 2)] = sum[r];
    }
  }
  __syncthreads();

  RowSeg own;
  own.set(seg_s, r0, L, l);
  uint32_t live = 0;  // the pair's tiles with a visible pair (its own rows' tile at least)
#pragma unroll
  for (int jt = 0; jt < kFusedTiles; ++jt)
    if (8 * jt < L && cols(own, seg_s, L, 8 * jt, l).live) live |= 1u << jt;
  const int nl = __popc(live);
  uint64_t list = 0, mine = 0;
  int nm = 0;
  {
    const uint64_t first = __ffs(live) - 1;
    for (int kq = 0; kq < kFusedTiles; ++kq) list |= first << (4 * kq);
    uint32_t m = live;
    for (int kq = 0; kq < nl; ++kq, m &= m - 1) {
      const uint64_t jt = __ffs(m) - 1;
      list = (list & ~(15ull << (4 * kq))) | jt << (4 * kq);
      if ((kq & 1) == half) mine |= jt << (4 * nm++);
    }
    for (int kq = nm; kq < kHalfTiles; ++kq) mine |= first << (4 * kq);
  }

  int last = -1;  // the last copy the steps so far read
  auto step = [&]() {  // a step that reads two copies: returns the first one's index
    cp_async_wait_n(issued - 1 - (last + 2));
    __syncthreads();
    issue(last + R);
    last += 2;
    return last - 1;
  };
  auto slot = [&](int i) { return slots + i % R * tile; };
  const float c2 = scale * kLog2e;
  {  // pass S
    float s[kHalfTiles][4] = {};
    for (int d = 0; d < nd; ++d) {
      const int u = step();  // Q_d, K_d
      listed_score_products(slot(u + 1), slot(u), r0, (min(kC, Dh - d * kC) + 7) / 8, nm, mine,
                            l, s);
    }
#pragma unroll
    for (int kq = 0; kq < kHalfTiles; ++kq) {
      if (kq < nm) {
        const int j0 = listed(mine, kq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, j = j0 + 2 * l.t + (e & 1);
          const bool on = own.ok[r] && j < L && seg_s[j] == own.seg[r];
          dst[(r0 + l.g + 8 * r) * lds + j] = on ? exp2f(fmaf(s[kq][e], c2, -lse2[j])) : 0.f;
        }
      }
    }
  }
  float dp[kHalfTiles][4] = {};
  for (int d = 0; d < nd; ++d) {  // pass P
    const int wd = min(kC, Dh - d * kC);
    const int u = step();  // dO_d, V_d
    listed_score_products(slot(u + 1), slot(u), r0, (wd + 7) / 8, nm, mine, l, dp);
    wide_fused_out<true>(dst, lds, r0, slot(u), c0, nl, list, dv, base + d * kC, HD, L, wd, 1.f,
                         l);
  }
  __syncthreads();  // every warp done with P^T in dV
#pragma unroll
  for (int kq = 0; kq < kHalfTiles; ++kq) {
    if (kq < nm) {
      const int j0 = listed(mine, kq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 2 * l.t + (e & 1);
        dst[(r0 + l.g + 8 * (e >> 1)) * lds + j] *= dp[kq][e] - di_s[j];  // P^T 0 where masked
      }
    }
  }
  for (int c = 0; c < nd; ++c) {  // pass B; the first step's barrier publishes dS^T
    const int wc = min(kC, Dh - c * kC);
    const int u = step();  // Q_c, K_c: dK = scale dS^T Q, then dQ = scale dS K
    wide_fused_out<true>(dst, lds, r0, slot(u), c0, nl, list, dk, base + c * kC, HD, L, wc, scale,
                         l);
    wide_fused_out<false>(dst, lds, r0, slot(u + 1), c0, nl, list, dq, base + c * kC, HD, L, wc,
                          scale, l);
  }
}

// ------------------------------------------------------------ long route
// Shared memory of a long-route block: its own two tiles and the two
// streamed ones double-buffered, [kTile][Long<DP>::kRs] each, and three row
// vectors [2][kTile].
template <int DP>
constexpr int64_t long_bytes() {
  return 4 * (6LL * Long<DP>::kTileFloats + 6LL * kTile);
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

  zero_pad_columns<DP>(reinterpret_cast<float*>(smem), 6, Dh, tid);
  load_tile_async<DP, RS>(ks, k, w.base, w.row0, kn, HD, Dh, vec, tid);
  load_tile_async<DP, RS>(vs, v, w.base, w.row0, kn, HD, Dh, vec, tid);
  auto prefetch = [&](int t) {
    const int buf = t & 1, q0 = t * kTile, n = min(kTile, L - q0);
    load_tile_async<DP, RS>(qs + buf * TF, q, w.base, q0, n, HD, Dh, vec, tid);
    load_tile_async<DP, RS>(dos + buf * TF, dout, w.base, q0, n, HD, Dh, vec, tid);
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

  zero_pad_columns<DP>(reinterpret_cast<float*>(smem), 6, Dh, tid);
  load_tile_async<DP, RS>(qs, q, w.base, w.row0, qn, HD, Dh, vec, tid);
  load_tile_async<DP, RS>(dos, dout, w.base, w.row0, qn, HD, Dh, vec, tid);
  auto prefetch = [&](int t) {
    const int buf = t & 1, k0 = t * kTile, n = min(kTile, L - k0);
    load_tile_async<DP, RS>(ks + buf * TF, k, w.base, k0, n, HD, Dh, vec, tid);
    load_tile_async<DP, RS>(vs + buf * TF, v, w.base, k0, n, HD, Dh, vec, tid);
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

// ------------------------------------------------------------ wide long route
// Dh > 64: a dK/dV kernel and a dQ kernel of one design. A block owns 64
// rows of one head (keys for dK/dV, queries for dQ) and a group of NC chunks
// of kC columns of their outputs: NC = 2 where Dh <= 128, else 4 (256
// columns); grid y counts the groups (wide_groups). For each streamed
// tile of 64 rows of the other side it runs
// * phase A: S^T and dP^T (dK/dV) or S and dP (dQ) of the 64 x 64 pairs over
//   the whole head dim, chunk by chunk from a ring in shared memory; half the
//   warps make S, half dP, each warp 16 rows in registers. Then P and D = dP
//   - di go to shared memory in the A-fragment order, with which 16 x 8
//   pieces hold a visible pair;
// * phase B: the group's outputs in halves of two chunks, each warp 16 rows
//   of dK or dV (kC columns of a chunk), or of dQ (kC / 2): its A fragments
//   are P or dS = P D from phase A's pieces, its B fragments the group's
//   chunks of the streamed rows, which the ring still holds.
// So S and dP are computed once per (block, tile) up to Dh 256, and once per
// group above it: twice at Dh 257-512, 3 times at 520.
//
// Warps of a block: 16 where a group is 2 chunks; 8 where it is 4, whose
// dK and dV accumulators (64 floats a lane with 16 warps, besides phase A's
// 16) spilled within 16 warps' 128 registers a thread, and fit 8 warps' 255.
__host__ __device__ constexpr int wide_warps(int NC) { return NC == 2 ? 16 : 8; }
constexpr int kOwnSlots = 2;   // own rows: K and V (dK/dV) or Q and dO (dQ), a chunk each
constexpr int kTileSlots = 4;  // streamed rows: Q and dO, or K and V, a chunk each


// Shared memory of a wide block at any Dh: the own and streamed rings (two
// tensors a slot), phase A's pieces (P and D), the row vectors of two
// streamed tiles (lse, di and seg for dK/dV, seg for dQ) and the pieces'
// liveness. Mirrored by ops/flash_attention.py::wide_bwd_smem_bytes.
__host__ __device__ constexpr int64_t wide_bwd_smem_bytes(bool dkv) {
  return 4LL * ((kOwnSlots + kTileSlots + 1) * 2 * kSwzTile + 2 * (dkv ? 3 : 1) * kTile + 4 * 8);
}

// The ring's schedule. A block's phase-A steps run in one sequence u = t nd +
// s (tile t, step s); step s takes chunk(s): the chunks outside the group
// first, then the group's, so that each tile ends with the ring holding the
// group's streamed chunks for phase B. Step u's copies go to tile slot u %
// kTileSlots and, unless the own rows stay resident (nd <= kOwnSlots), own
// slot u % kOwnSlots. They are issued at a barrier once the slots' last users
// are done: step u - kOwnSlots, and step u - kTileSlots, which, if it held a
// chunk i of the group, phase B reads until its half i / 2 is done; all the
// copies issued at one barrier form one cp.async group. A step whose copies
// an earlier barrier made visible needs no barrier of its own.
struct Ring {
  int nd, nng, g0, nh, nt;
  bool own_resident;
  int next_t = 0, next_s = 0;  // the next step to issue
  int visible = 0;             // steps whose copies every thread sees
  __device__ __forceinline__ int chunk(int s) const {
    return s >= nng ? g0 + s - nng : s < g0 ? s : s + (nd - nng);
  }
  __device__ __forceinline__ int next() const { return next_t * nd + next_s; }
  __device__ __forceinline__ void advance() {
    if (++next_s == nd) {
      next_s = 0;
      ++next_t;
    }
  }
  // whether the next step may be issued: v phase-A steps and hb phase-B
  // halves are done
  __device__ __forceinline__ bool ready(int v, int hb) const {
    if (next_t >= nt || (!own_resident && next() - kOwnSlots >= v)) return false;
    int pt = next_t, ps = next_s - kTileSlots;  // the tile slot's last user
    while (ps < 0) {
      ps += nd;
      --pt;
    }
    if (pt < 0) return true;
    return ps < nng ? pt * nd + ps < v : hb > pt * nh + (ps - nng) / 2;
  }
};

// Phase B, one chunk of one output: acc += A X over the tile's 64 rows, A the
// warp's pieces jt of P (kDs: P times D, i.e. dS) from phase A, live ones
// only; X the chunk's columns [c0, c0 + 8 NN) below wc of the streamed rows,
// read in load_b_acc's order: rows 8 jt + 2 t and 8 jt + 2 t + 1, which
// swizzle by 8 t and 8 t + 4.
template <bool kDs, int NN>
__device__ __forceinline__ void wide_piece_products(const float4* p, const float4* d,
                                                    const int* live, const float* x, int c0,
                                                    int wc, Lane l, float (&acc)[NN][4]) {
  const int lane_id = threadIdx.x & 31;
  const float* x0 = x + 2 * l.t * kC + l.g;
  const float* x1 = x + (2 * l.t + 1) * kC + (l.g ^ 4);
  for (int jt = 0; jt < kTile / 8; ++jt) {
    if (!live[jt]) continue;
    float4 f = p[jt * 32 + lane_id];
    if (kDs) {
      const float4 e = d[jt * 32 + lane_id];
      f = make_float4(f.x * e.x, f.y * e.y, f.z * e.z, f.w * e.w);
    }
    const FragA a = split_a(f.x, f.y, f.z, f.w);
    const int row = 8 * jt * kC;
#pragma unroll
    for (int nn = 0; nn < NN; ++nn) {
      const int cc = row + ((c0 + 8 * nn) ^ (8 * l.t));
      if (c0 + 8 * nn < wc) mma3(acc[nn], a, split_b(x0[cc], x1[cc]));
    }
  }
}

// What both kernels share: the block's place, its ring and slots, and the
// roles of its W warps. Phase A: warp w makes S (kind 0) or dP (kind 1, w >=
// W / 2) for own rows 16 (w % 4) against NT = 64 / W pieces of 8 streamed
// rows, from row 8 NT (w / 4 % (W / 8)). Phase B: warp w makes own rows 16
// (w % 4) on CPW = 16 / W group chunks 2 h + w / 8 + j (j < CPW) in half h.
template <int NC>
struct WideBlock {
  static constexpr int W = wide_warps(NC), kThreads = 32 * W, NT = 64 / W, CPW = 16 / W;
  static constexpr int NH = NC / 2;
  Where w;
  int kn, nt;
  Ring ring;
  float* own;  // [kOwnSlots][2][kSwzTile], then [kTileSlots][2][kSwzTile]
  int warp, r, jq, kind;

  __device__ __forceinline__ WideBlock(int L, int H, int Dh, float* smem)
      : w(where(L, H, Dh)), own(smem) {
    kn = min(kTile, L - w.row0);
    nt = (L + kTile - 1) / kTile;
    const int nd = chunks(Dh), g0 = blockIdx.y * NC, ngc = min(NC, nd - g0);
    ring = Ring{nd, nd - ngc, g0, NH, nt, nd <= kOwnSlots};
    warp = threadIdx.x >> 5;
    r = warp & 3;
    jq = (warp >> 2) % (W / 8);
    kind = warp / (W / 2);
  }
  __device__ __forceinline__ float* own_slot(int u, int m) const {
    return own + ((u & (kOwnSlots - 1)) * 2 + m) * kSwzTile;
  }
  __device__ __forceinline__ float* tile_slot(int u, int m) const {
    return own + ((kOwnSlots + (u & (kTileSlots - 1))) * 2 + m) * kSwzTile;
  }
  // P and D: [2][4 own slabs][8 streamed pieces][32 lanes]
  __device__ __forceinline__ float4* pieces() const {
    return reinterpret_cast<float4*>(own + (kOwnSlots + kTileSlots) * 2 * kSwzTile);
  }
  __device__ __forceinline__ float* after_pieces() const {
    return own + (kOwnSlots + kTileSlots + 1) * 2 * kSwzTile;
  }
  // group chunk of the warp's j-th output slab in half h
  __device__ __forceinline__ int chunk_of(int h, int j) const { return 2 * h + (warp >> 3) + j; }
  // The next step's copies of its chunk: of x0, x1 (the own rows; where they
  // stay resident, at steps 0 and 1 only) and of y0, y1 (the tile's rows).
  __device__ __forceinline__ void copy_step(const float* x0, const float* x1, const float* y0,
                                            const float* y1, int L, int H, int Dh,
                                            bool vec) const {
    const int HD = H * Dh, tid = threadIdx.x, u = ring.next();
    const int d0 = ring.chunk(ring.next_s) * kC, wd = min(kC, Dh - d0);
    const int r0 = ring.next_t * kTile, n = min(kTile, L - r0);
    if (!ring.own_resident || u < kOwnSlots) {
      load_swz_async(own_slot(u, 0), x0, w.base + d0, w.row0, kn, HD, wd, vec, tid, kThreads);
      load_swz_async(own_slot(u, 1), x1, w.base + d0, w.row0, kn, HD, wd, vec, tid, kThreads);
    }
    load_swz_async(tile_slot(u, 0), y0, w.base + d0, r0, n, HD, wd, vec, tid, kThreads);
    load_swz_async(tile_slot(u, 1), y1, w.base + d0, r0, n, HD, wd, vec, tid, kThreads);
  }
  // Phase A's step u for the warp's piece (S from slots 0, dP from slots 1).
  __device__ __forceinline__ void products(int u, int st, int Dh, const bool (&live)[NT],
                                           Lane l, float (&acc)[NT][4]) const {
    bool any = false;
#pragma unroll
    for (int i = 0; i < NT; ++i) any |= live[i];
    if (!any) return;
    const int ks = (min(kC, Dh - ring.chunk(st) * kC) + 7) / 8;
    wide_score_products<NT>(own_slot(u, kind), tile_slot(u, kind), 16 * r, 8 * NT * jq, ks, live,
                            l, acc);
  }
  // The liveness of the warp's pieces for the tile's seg (n rows).
  __device__ __forceinline__ void liveness(const RowSeg& rs, const int* seg_t, int n, Lane l,
                                           bool (&live)[NT]) const {
#pragma unroll
    for (int i = 0; i < NT; ++i) live[i] = cols(rs, seg_t, n, 8 * (NT * jq + i), l).live;
  }
  // Piece i of the warp's results (4 floats a lane, accumulator order) into
  // P (kind 0) or D (kind 1), in the A-fragment order of acc_as_a.
  __device__ __forceinline__ void put_piece(int i, const float (&x)[4]) const {
    pieces()[((kind * 4 + r) * 8 + NT * jq + i) * 32 + (threadIdx.x & 31)] =
        make_float4(x[0], x[2], x[1], x[3]);
  }
};

// dK and dV of the block's 64 keys on its group of NC chunks; the queries
// stream through in tiles of 64. Phase A makes S^T and dP^T; phase B's warp
// w makes dV += P^T dO (w / 4 even) or dK += dS^T Q.
template <int NC>
__global__ void __launch_bounds__(32 * wide_warps(NC), 1)
flash_bwd_dkv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ seg,
                          const float* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ di, float* __restrict__ dk,
                          float* __restrict__ dv, int L, int H, int Dh, float scale, bool vec) {
  using Blk = WideBlock<NC>;
  constexpr int NH = Blk::NH, NT = Blk::NT, CPW = Blk::CPW;
  extern __shared__ float4 smem[];
  Blk blk(L, H, Dh, reinterpret_cast<float*>(smem));
  float* vecs = blk.after_pieces();                            // [2][lse, di, seg][kTile]
  int* live_s = reinterpret_cast<int*>(vecs + 2 * 3 * kTile);  // [4][8]
  const int tid = threadIdx.x, nd = blk.ring.nd, ngc = nd - blk.ring.nng;
  const int64_t seg_b = (int64_t)blk.w.b * L;
  const Lane l = lane();
  const float c2 = scale * kLog2e;

  RowSeg own;
  own.set(seg + seg_b + blk.w.row0, 16 * blk.r, blk.kn, l);
  auto issue = [&](int v_done, int hb) {
    bool any = false;
    for (; blk.ring.ready(v_done, hb); blk.ring.advance(), any = true) {
      blk.copy_step(k, v, q, dout, L, H, Dh, vec);
      if (blk.ring.next_s == 0) {
        const int t = blk.ring.next_t, q0 = t * kTile, n = min(kTile, L - q0);
        float* vs = vecs + (t & 1) * 3 * kTile;
        for (int e = tid; e < n; e += Blk::kThreads) {
          cp_async4(vs + e, lse + blk.w.rows + q0 + e);
          cp_async4(vs + kTile + e, di + blk.w.rows + q0 + e);
          cp_async4(vs + 2 * kTile + e, seg + seg_b + q0 + e);
        }
      }
    }
    if (any) cp_async_commit();
  };
  issue(0, 0);

  const bool dkw = (blk.warp >> 2) & 1;  // phase B: dK += dS^T Q, else dV += P^T dO
  float acc[NH][CPW][kC / 8][4] = {};
  for (int t = 0; t < blk.nt; ++t) {
    const int n = min(kTile, L - t * kTile);
    const float* lse_t = vecs + (t & 1) * 3 * kTile;
    const float* di_t = lse_t + kTile;
    const int* seg_t = reinterpret_cast<const int*>(lse_t + 2 * kTile);
    float sd[NT][4] = {};  // S^T or dP^T
    bool live[NT];
    for (int st = 0; st < nd; ++st) {
      const int u = t * nd + st;
      // a barrier where step u's copies are not yet visible (then every copy
      // issued is waited for) or where the steps done free a slot
      const bool wait = st == 0 || u >= blk.ring.visible;
      if (wait || blk.ring.ready(u, t * NH)) {
        if (wait) cp_async_wait<0>();
        __syncthreads();
        if (wait) blk.ring.visible = blk.ring.next();
        issue(u, t * NH);
      }
      if (st == 0) blk.liveness(own, seg_t, n, l, live);
      blk.products(u, st, Dh, live, l, sd);
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int j0 = 8 * (NT * blk.jq + i);
      if (blk.kind == 0 && tid % 32 == 0) live_s[blk.r * 8 + j0 / 8] = live[i];
      if (!live[i]) continue;
      float x[4];
      if (blk.kind == 0) {  // P^T
        const Cols c = cols(own, seg_t, n, j0, l);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = e >> 1, ii = e & 1, j = min(j0 + 2 * l.t + ii, n - 1);
          const bool on = own.ok[ri] && c.ok[ii] && c.seg[ii] == own.seg[ri];
          x[e] = on ? exp2f(fmaf(sd[i][e], c2, -lse_t[j] * kLog2e)) : 0.f;
        }
      } else {  // D^T = dP^T - di
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = sd[i][e] - di_t[min(j0 + 2 * l.t + (e & 1), n - 1)];
      }
      blk.put_piece(i, x);
    }
    __syncthreads();
    issue((t + 1) * nd, t * NH);
    const float4* p = blk.pieces() + blk.r * 8 * 32;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      if (h > 0) {
        __syncthreads();
        issue((t + 1) * nd, t * NH + h);
      }
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        const int ci = blk.chunk_of(h, j);
        if (ci >= ngc) continue;
        const int u = t * nd + blk.ring.nng + ci, wc = min(kC, Dh - (blk.ring.g0 + ci) * kC);
        if (dkw)
          wide_piece_products<true>(p, p + 4 * 8 * 32, live_s + blk.r * 8, blk.tile_slot(u, 0),
                                    0, wc, l, acc[h][j]);
        else
          wide_piece_products<false>(p, p, live_s + blk.r * 8, blk.tile_slot(u, 1), 0, wc, l,
                                     acc[h][j]);
      }
    }
  }
  const int HD = H * Dh;
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
      const int ci = blk.chunk_of(h, j);
      if (ci >= ngc) continue;
      const int c0 = (blk.ring.g0 + ci) * kC;
      store_acc<kC>(dkw ? dk : dv, blk.w.base + c0, HD, blk.w.row0 + 16 * blk.r, L, Dh - c0,
                    acc[h][j], dkw ? scale : 1.f, l);
    }
}

// dQ of the block's 64 queries on its group of NC chunks; the keys stream
// through in tiles of 64. Phase A makes S and dP; phase B's warp w makes dQ
// += dS K on columns kC / 2 (w / 4 % 2) of its chunks.
template <int NC>
__global__ void __launch_bounds__(32 * wide_warps(NC), 1)
flash_bwd_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ seg,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ di, float* __restrict__ dq, int L, int H,
                         int Dh, float scale, bool vec) {
  using Blk = WideBlock<NC>;
  constexpr int NH = Blk::NH, NT = Blk::NT, CPW = Blk::CPW, kHalf = kC / 2;
  extern __shared__ float4 smem[];
  Blk blk(L, H, Dh, reinterpret_cast<float*>(smem));
  int* seg_s = reinterpret_cast<int*>(blk.after_pieces());  // [2][kTile]
  int* live_s = seg_s + 2 * kTile;                           // [4][8]
  const int tid = threadIdx.x, nd = blk.ring.nd, ngc = nd - blk.ring.nng;
  const int64_t seg_b = (int64_t)blk.w.b * L;
  const Lane l = lane();
  const float c2 = scale * kLog2e;

  RowSeg own;
  own.set(seg + seg_b + blk.w.row0, 16 * blk.r, blk.kn, l);
  auto issue = [&](int v_done, int hb) {
    bool any = false;
    for (; blk.ring.ready(v_done, hb); blk.ring.advance(), any = true) {
      blk.copy_step(q, dout, k, v, L, H, Dh, vec);
      if (blk.ring.next_s == 0) {
        const int t = blk.ring.next_t, k0 = t * kTile, n = min(kTile, L - k0);
        for (int e = tid; e < n; e += Blk::kThreads)
          cp_async4(seg_s + (t & 1) * kTile + e, seg + seg_b + k0 + e);
      }
    }
    if (any) cp_async_commit();
  };
  issue(0, 0);

  const int cb = ((blk.warp >> 2) & 1) * kHalf;  // the warp's columns of its chunks
  float acc[NH][CPW][kHalf / 8][4] = {};
  for (int t = 0; t < blk.nt; ++t) {
    const int n = min(kTile, L - t * kTile);
    const int* seg_t = seg_s + (t & 1) * kTile;
    float sd[NT][4] = {};  // S or dP
    bool live[NT];
    for (int st = 0; st < nd; ++st) {
      const int u = t * nd + st;
      // a barrier where step u's copies are not yet visible (then every copy
      // issued is waited for) or where the steps done free a slot
      const bool wait = st == 0 || u >= blk.ring.visible;
      if (wait || blk.ring.ready(u, t * NH)) {
        if (wait) cp_async_wait<0>();
        __syncthreads();
        if (wait) blk.ring.visible = blk.ring.next();
        issue(u, t * NH);
      }
      if (st == 0) blk.liveness(own, seg_t, n, l, live);
      blk.products(u, st, Dh, live, l, sd);
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int j0 = 8 * (NT * blk.jq + i);
      if (blk.kind == 0 && tid % 32 == 0) live_s[blk.r * 8 + j0 / 8] = live[i];
      if (!live[i]) continue;
      float x[4];
      const Cols c = cols(own, seg_t, n, j0, l);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1, ii = e & 1;
        const int64_t row = blk.w.rows + min(blk.w.row0 + 16 * blk.r + l.g + 8 * ri, L - 1);
        const bool on = own.ok[ri] && c.ok[ii] && c.seg[ii] == own.seg[ri];
        x[e] = blk.kind == 0 ? (on ? exp2f(fmaf(sd[i][e], c2, -lse[row] * kLog2e)) : 0.f)
                             : sd[i][e] - di[row];  // P, or D = dP - di
      }
      blk.put_piece(i, x);
    }
    __syncthreads();
    issue((t + 1) * nd, t * NH);
    const float4* p = blk.pieces() + blk.r * 8 * 32;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      if (h > 0) {
        __syncthreads();
        issue((t + 1) * nd, t * NH + h);
      }
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        const int ci = blk.chunk_of(h, j);
        if (ci >= ngc) continue;
        const int u = t * nd + blk.ring.nng + ci, wc = min(kC, Dh - (blk.ring.g0 + ci) * kC);
        wide_piece_products<true>(p, p + 4 * 8 * 32, live_s + blk.r * 8, blk.tile_slot(u, 0), cb,
                                  wc, l, acc[h][j]);  // dQ += dS K
      }
    }
  }
  const int HD = H * Dh;
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
      const int ci = blk.chunk_of(h, j);
      if (ci >= ngc) continue;
      const int c0 = (blk.ring.g0 + ci) * kC + cb;
      store_acc<kHalf>(dq, blk.w.base + c0, HD, blk.w.row0 + 16 * blk.r, L, Dh - c0,
                       acc[h][j], scale, l);
    }
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

template <int DP, bool kTail4>
struct Launch {
  static void run(const Which& which, const Args& a, const cudaStream_t& s) {
    const bool vec4 = aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.dout);
    if (which == kFused) {
      const bool vec = vec4 && ((int64_t)a.L * a.H * a.Dh) % 4 == 0;
      const int threads = (a.L + 15) / 16 * 32;
      launch_kernel(flash_bwd_fused_kernel<DP, kTail4>, (unsigned)a.B, threads,
                    narrow_fused_smem_bytes(a.L, a.H, a.Dh), s, a.q, a.k, a.v, a.seg, a.o,
                    a.dout, a.lse, a.dq, a.dk, a.dv, a.L, a.H, a.Dh, a.scale, vec);
      return;
    }
    const bool vec = vec4 && a.Dh % 4 == 0;
    const unsigned grid = (unsigned)((int64_t)a.B * ((a.L + kTile - 1) / kTile) * a.H);
    if (which == kDkv)
      launch_kernel(flash_bwd_dkv_kernel<DP, kTail4>, grid, kLongThreads, long_bytes<DP>(), s,
                    a.q, a.k, a.v, a.seg, a.dout, a.lse, a.di, a.dk, a.dv, a.L, a.H, a.Dh,
                    a.scale, vec);
    else
      launch_kernel(flash_bwd_dq_kernel<DP, kTail4>, grid, kLongThreads, long_bytes<DP>(), s,
                    a.q, a.k, a.v, a.seg, a.dout, a.lse, a.di, a.dq, a.L, a.H, a.Dh, a.scale,
                    vec);
  }

  // Dh > 64, in chunks of kC = DP columns
  static void run_wide(const Which& which, const Args& a, const cudaStream_t& s) {
    const bool vec4 = aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.dout);
    if (which == kFused) {
      launch_kernel(flash_bwd_fused_wide_kernel, (unsigned)((int64_t)a.B * a.H),
                    round16(a.L) / 16 * 64, wide_fused_smem_bytes(a.L), s, a.q, a.k, a.v, a.seg,
                    a.o, a.dout, a.lse, a.dq, a.dk, a.dv, a.L, a.H, a.Dh, a.scale,
                    vec4 && aligned16(a.o) && a.Dh % 4 == 0);
      return;
    }
    const dim3 grid((unsigned)((int64_t)a.B * ((a.L + kTile - 1) / kTile) * a.H),
                    (unsigned)wide_groups(a.Dh));
    if (wide_group_chunks(a.Dh) == 2)
      run_wide_long<2>(which, a, s, grid, vec4 && a.Dh % 4 == 0);
    else
      run_wide_long<4>(which, a, s, grid, vec4 && a.Dh % 4 == 0);
  }

  template <int NC>
  static void run_wide_long(Which which, const Args& a, cudaStream_t s, dim3 grid, bool vec) {
    if (which == kDkv)
      launch_kernel(flash_bwd_dkv_wide_kernel<NC>, grid, 32 * wide_warps(NC),
                    wide_bwd_smem_bytes(true),
                    s, a.q, a.k, a.v, a.seg, a.dout, a.lse, a.di, a.dk, a.dv, a.L, a.H, a.Dh,
                    a.scale, vec);
    else
      launch_kernel(flash_bwd_dq_wide_kernel<NC>, grid, 32 * wide_warps(NC),
                    wide_bwd_smem_bytes(false),
                    s, a.q, a.k, a.v, a.seg, a.dout, a.lse, a.di, a.dq, a.L, a.H, a.Dh, a.scale,
                    vec);
  }
};

template <int DP, bool kTail4>
struct Info {
  static void run(Which which, int, int* out) {
    if (which == kDkv)
      kernel_info(flash_bwd_dkv_kernel<DP, kTail4>, kLongThreads, long_bytes<DP>(), out);
    else
      kernel_info(flash_bwd_dq_kernel<DP, kTail4>, kLongThreads, long_bytes<DP>(), out);
  }
  static void run_wide(Which which, int Dh, int* out) {
    if (wide_group_chunks(Dh) == 2)
      by_group<2>(which, out);
    else
      by_group<4>(which, out);
  }
  template <int NC>
  static void by_group(Which which, int* out) {
    if (which == kDkv)
      kernel_info(flash_bwd_dkv_wide_kernel<NC>, 32 * wide_warps(NC), wide_bwd_smem_bytes(true),
                  out);
    else
      kernel_info(flash_bwd_dq_wide_kernel<NC>, 32 * wide_warps(NC), wide_bwd_smem_bytes(false),
                  out);
  }
};

int64_t fused_smem_bytes(int L, int H, int Dh) {
  return Dh > kNarrowMaxDh ? wide_fused_smem_bytes(L) : narrow_fused_smem_bytes(L, H, Dh);
}

int dispatch(Which which, const Args& a, void* stream) {
  if (!shape_ok(a.B, a.L, a.H, a.Dh)) return (int)cudaErrorInvalidValue;
  if (which == kFused &&
      (a.L > kFusedMaxL || fused_smem_bytes(a.L, a.H, a.Dh) > kMaxSmem))
    return (int)cudaErrorInvalidValue;
  by_head_dim<Launch>(a.Dh, which, a, static_cast<cudaStream_t>(stream));
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

// The wide long route's column groups at Dh (blocks in grid y; 0 for Dh <=
// 64) and the shared memory of its dK/dV (dkv != 0) or dQ block, as
// ops/flash_attention.py counts them.
extern "C" int rtt_flash_attention_bwd_wide_groups(int Dh) {
  return Dh > kNarrowMaxDh ? wide_groups(Dh) : 0;
}

extern "C" long long rtt_flash_attention_bwd_wide_smem(int dkv) {
  return wide_bwd_smem_bytes(dkv != 0);
}

// Registers, local memory bytes a thread and blocks an SM (out[0..2]) of the
// wide fused backward (Dh > 64, L <= 128) as its launch at [., L, H, Dh]
// configures it (its threads and shared memory follow L alone).
extern "C" int rtt_flash_attention_bwd_fused_wide_info(int L, int H, int Dh, int* out) {
  if (Dh <= kNarrowMaxDh || L < 1 || L > kFusedMaxL || H < 1) return (int)cudaErrorInvalidValue;
  kernel_info(flash_bwd_fused_wide_kernel, round16(L) / 16 * 64, wide_fused_smem_bytes(L), out);
  return (int)cudaGetLastError();
}

// Registers, local memory bytes a thread and blocks an SM (out[0..2]) of the
// long route's dK/dV (dkv != 0) or dQ kernel at Dh.
extern "C" int rtt_flash_attention_bwd_long_info(int dkv, int Dh, int* out) {
  if (Dh < 1) return (int)cudaErrorInvalidValue;
  by_head_dim<Info>(Dh, dkv ? kDkv : kDq, Dh, out);
  return (int)cudaGetLastError();
}
