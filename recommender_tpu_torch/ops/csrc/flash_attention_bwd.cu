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
// 6. Head dims above 64 (flash_mma.cuh): a warp's own rows as A fragments
//    and its dK, dV accumulators would not fit its registers, nor the long
//    tiles shared memory, so a wide Dh runs in chunks of 64 columns. Each
//    long-route block owns one chunk of its outputs (grid y): for each tile
//    of 64 rows of the other side it copies the chunks of its own rows and
//    of the tile's one at a time (its own chunk last), adds S^T and dP^T
//    (dK/dV) or S and dP (dQ) up in registers, then makes P and dS and the
//    products on its chunk, which the tiles still hold (70 KB, one copy in
//    flight a block). The fused route keeps its block: per head, the key
//    side makes dK and dV a chunk at a time, S^T and dP^T computed again
//    over every column for each chunk and dS^T kept from the first, and
//    the query side dQ a chunk at a time from dS^T. Measured on an NVIDIA
//    H100 80GB HBM3 at 700 W (chip_smoke.py phase k2): the L1001 probe at
//    Dh 128, H 4: dK/dV 18.7 ms and dQ 14.6 ms alone, 12% and 11% of their
//    2.17 and 1.63 ms (operations) bounds; BST's rows with one head of Dh
//    128 (long): 0.69 and 0.54 ms, 14% and 15% of their (bytes) bounds;
//    Dh 72 fused: 0.65 ms, 11%; Dh 256, B 256, H 2: 1.15 and 0.93 ms, 8%
//    and 9%. nvcc -Xptxas -v (chip_smoke.py --ptxas, the same card): dK/dV
//    205 registers, dQ 168, the wide fused kernel 157, no spills.
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

// q, k, v, dO spans, dS^T [L][fused_lds], lse and di [H][L], seg [L].
// Mirrored by ops/flash_attention.py.
int64_t fused_smem_bytes(int L, int H, int Dh) {
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

// Wide head dims: s += X Y^T and dp += Z W^T over ng groups of 8 columns,
// X and Z the warp's own 16 rows from r0 read from shared memory as A
// fragments, Y and W the 8 rows at j0 (B).
__device__ __forceinline__ void wide_products(const View& x, const View& z, const View& y,
                                              const View& w, int r0, int j0, int ng, Lane l,
                                              Acc3& s, Acc3& dp) {
  for (int kk = 0; kk < ng; ++kk) {
    s.add(load_a(x, r0, 8 * kk, l), load_bt(y, j0, 8 * kk, l));
    dp.add(load_a(z, r0, 8 * kk, l), load_bt(w, j0, 8 * kk, l));
  }
}

// The same for the 8 tiles of a long block's streamed side at once
// (j0 = 8 jt for the live tiles jt), the A fragments split once for all.
__device__ __forceinline__ void wide_products_tiles(const View& x, const View& z,
                                                    const View& y, const View& w, int r0,
                                                    int ng, uint32_t live, Lane l,
                                                    float (&s)[8][4], float (&dp)[8][4]) {
  for (int kk = 0; kk < ng; ++kk) {
    const FragA ax = load_a(x, r0, 8 * kk, l), az = load_a(z, r0, 8 * kk, l);
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      if (!(live >> jt & 1)) continue;
      mma3(s[jt], ax, load_bt(y, 8 * jt, 8 * kk, l));
      mma3(dp[jt], az, load_bt(w, 8 * jt, 8 * kk, l));
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
// kWide (Dh > 64, DP = kC): the key side makes dK and dV a chunk of kC
// columns at a time, S^T and dP^T over every column from shared memory
// again for each (dS^T is kept from the first); the query side makes dQ a
// chunk at a time from the kept dS^T.
template <int DP, bool kTail4, bool kWide = false>
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
  if constexpr (kWide) {
    RowSeg own;
    own.set(seg_s, r0, L, l);
    const int ng = (Dh + 7) / 8;
    for (int h = 0; h < H; ++h) {
      const View qv{qs + h * Dh, HD, L, Dh}, kv{ks + h * Dh, HD, L, Dh};
      const View vv{vs + h * Dh, HD, L, Dh}, dov{dos + h * Dh, HD, L, Dh};
      const int64_t obase = base + (int64_t)h * Dh;
      for (int c0 = 0; c0 < Dh; c0 += kC) {  // the warp's keys, a chunk at a time
        const int wc = min(kC, Dh - c0), nw = (wc + 7) / 8;
        const View qc{qs + h * Dh + c0, HD, L, wc}, doc{dos + h * Dh + c0, HD, L, wc};
        Acc<DP> dka, dva;
        zero<DP>(dka);
        zero<DP>(dva);
        for (int j0 = 0; j0 < L; j0 += 8) {
          const Cols c = cols(own, seg_s, L, j0, l);
          float ds[4] = {0.f, 0.f, 0.f, 0.f};
          if (c.live) {
            Acc3 s, dp;
            wide_products(kv, vv, qv, dov, r0, j0, ng, l, s, dp);
            float p[4], ss[4], dps[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ss[e] = s.sum(e);
              dps[e] = dp.sum(e);
            }
            key_side_probs(own, c, ss, dps, lse_s + h * L, di_s + h * L, L, j0, c2, l, p, ds);
            const FragA pa = acc_as_a(p), da = acc_as_a(ds);
#pragma unroll
            for (int nn = 0; nn < DP / 8; ++nn) {
              if (nn >= nw) break;
              mma3(dva[nn], pa, load_b_acc(doc, j0, 8 * nn, l));
              mma3(dka[nn], da, load_b_acc(qc, j0, 8 * nn, l));
            }
          }
          if (c0 == 0)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = r0 + l.g + 8 * (e >> 1), j = j0 + 2 * l.t + (e & 1);
              if (row < L && j < L) dst[row * lds + j] = ds[e];
            }
        }
        store_acc<DP>(dk, obase + c0, HD, r0, L, wc, dka, scale, l);
        store_acc<DP>(dv, obase + c0, HD, r0, L, wc, dva, 1.f, l);
      }
      __syncthreads();
      const View dsv{dst, lds, L, L};  // (key, query)
      const int qseg0 = seg_s[min(r0 + l.g, L - 1)], qseg1 = seg_s[min(r0 + l.g + 8, L - 1)];
      for (int c0 = 0; c0 < Dh; c0 += kC) {  // the warp's queries, a chunk at a time
        const int wc = min(kC, Dh - c0), nw = (wc + 7) / 8;
        const View kc{ks + h * Dh + c0, HD, L, wc};
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
          for (int nn = 0; nn < DP / 8; ++nn)
            if (nn < nw) mma3(dqa[nn], a, load_b(kc, k0, 8 * nn, l));
        }
        store_acc<DP>(dq, obase + c0, HD, r0, L, wc, dqa, scale, l);
      }
      __syncthreads();  // before the next head's dS^T
    }
    return;
  }
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
// Shared memory of a wide long-route block: four chunk tiles ([kTile][kCs]
// each: the block's own two, the streamed side's two) and three row
// vectors [kTile].
__host__ __device__ constexpr int64_t wide_long_bytes() { return 4 * (4LL * kCTile + 3LL * kTile); }

// dK and dV's chunk blockIdx.y (kC columns) of the block's 64 keys. For each
// tile of 64 queries the block takes the chunks of K, V (its own rows) and
// Q, dO (the tile's) one by one, adding up S^T and dP^T of its warps in
// registers, chunk c last; then P^T and dS^T, and dV += P^T dO, dK += dS^T Q
// on chunk c, which the tiles still hold.
__global__ void __launch_bounds__(kLongThreads, 2)
flash_bwd_dkv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ seg,
                          const float* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ di, float* __restrict__ dk,
                          float* __restrict__ dv, int L, int H, int Dh, float scale, bool vec) {
  extern __shared__ float4 smem[];
  float* kt = reinterpret_cast<float*>(smem);
  float* vt = kt + kCTile;
  float* qt = vt + kCTile;
  float* dot = qt + kCTile;
  float* lse_s = dot + kCTile;  // [kTile], then times log2 e
  float* di_s = lse_s + kTile;
  int* seg_s = reinterpret_cast<int*>(di_s + kTile);
  const Where w = where(L, H, Dh);
  const int HD = H * Dh, tid = threadIdx.x, r0 = 16 * (tid >> 5);
  const int kn = min(kTile, L - w.row0), nt = (L + kTile - 1) / kTile;
  const int nd = chunks(Dh), c0 = blockIdx.y * kC, wc = min(kC, Dh - c0);
  const int64_t seg_b = (int64_t)w.b * L;
  const Lane l = lane();
  const float c2 = scale * kLog2e;

  zero_smem(smem, (int)(wide_long_bytes() / 16), tid, kLongThreads);
  RowSeg own;
  own.set(seg + seg_b + w.row0, r0, kn, l);
  Acc<kC> dka, dva;
  zero<kC>(dka);
  zero<kC>(dva);
  for (int t = 0; t < nt; ++t) {
    const int q0 = t * kTile, n = min(kTile, L - q0);
    float s[8][4] = {}, dp[8][4] = {};
    uint32_t live = 0;
    for (int i = 0; i < nd; ++i) {
      const int d0 = chunk_at(i, blockIdx.y, nd) * kC, wd = min(kC, Dh - d0);
      __syncthreads();  // every warp is done with the tiles
      load_chunk_async(kt, k, w.base, d0, w.row0, kn, HD, wd, vec, tid);
      load_chunk_async(vt, v, w.base, d0, w.row0, kn, HD, wd, vec, tid);
      load_chunk_async(qt, q, w.base, d0, q0, n, HD, wd, vec, tid);
      load_chunk_async(dot, dout, w.base, d0, q0, n, HD, wd, vec, tid);
      if (i == 0)
        for (int e = tid; e < n; e += kLongThreads) {
          cp_async4(lse_s + e, lse + w.rows + q0 + e);
          cp_async4(di_s + e, di + w.rows + q0 + e);
          cp_async4(seg_s + e, seg + seg_b + q0 + e);
        }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (i == 0) {  // the tiles with a visible pair; lse2 for the last chunk (nd >= 2)
#pragma unroll
        for (int jt = 0; jt < 8; ++jt)
          if (8 * jt < n && cols(own, seg_s, n, 8 * jt, l).live) live |= 1u << jt;
        for (int e = tid; e < n; e += kLongThreads) lse_s[e] *= kLog2e;
      }
      wide_products_tiles(View{kt, kCs, kn, wd}, View{vt, kCs, kn, wd}, View{qt, kCs, n, wd},
                          View{dot, kCs, n, wd}, r0, (wd + 7) / 8, live, l, s, dp);
    }
    const View qc{qt, kCs, n, wc}, doc{dot, kCs, n, wc};
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      if (!(live >> jt & 1)) continue;
      float p[4], ds[4];
      key_side_probs(own, cols(own, seg_s, n, 8 * jt, l), s[jt], dp[jt], lse_s, di_s, n,
                     8 * jt, c2, l, p, ds);
      const FragA pa = acc_as_a(p), da = acc_as_a(ds);
#pragma unroll
      for (int nn = 0; nn < kC / 8; ++nn) {
        if (8 * nn >= wc) break;
        mma3(dva[nn], pa, load_b_acc(doc, 8 * jt, 8 * nn, l));
        mma3(dka[nn], da, load_b_acc(qc, 8 * jt, 8 * nn, l));
      }
    }
  }
  store_acc<kC>(dk, w.base + c0, HD, w.row0 + r0, L, wc, dka, scale, l);
  store_acc<kC>(dv, w.base + c0, HD, w.row0 + r0, L, wc, dva, 1.f, l);
}

// dQ's chunk blockIdx.y of the block's 64 queries: for each tile of 64 keys
// the chunks of Q, dO (its own rows) and K, V (the tile's) one by one, S and
// dP added up in registers, chunk c last; then dS and dQ += dS K on chunk c.
__global__ void __launch_bounds__(kLongThreads, 2)
flash_bwd_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ seg,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ di, float* __restrict__ dq, int L, int H,
                         int Dh, float scale, bool vec) {
  extern __shared__ float4 smem[];
  float* qt = reinterpret_cast<float*>(smem);
  float* dot = qt + kCTile;
  float* kt = dot + kCTile;
  float* vt = kt + kCTile;
  int* seg_s = reinterpret_cast<int*>(vt + kCTile);
  const Where w = where(L, H, Dh);
  const int HD = H * Dh, tid = threadIdx.x, r0 = 16 * (tid >> 5);
  const int qn = min(kTile, L - w.row0), nt = (L + kTile - 1) / kTile;
  const int nd = chunks(Dh), c0 = blockIdx.y * kC, wc = min(kC, Dh - c0);
  const int64_t seg_b = (int64_t)w.b * L;
  const Lane l = lane();
  const float c2 = scale * kLog2e;

  zero_smem(smem, (int)(wide_long_bytes() / 16), tid, kLongThreads);
  RowSeg own;
  own.set(seg + seg_b + w.row0, r0, qn, l);
  float lse2[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(w.row0 + r0 + l.g + 8 * r, L - 1);
    lse2[r] = lse[w.rows + row] * kLog2e;
    di_r[r] = di[w.rows + row];
  }
  Acc<kC> dqa;
  zero<kC>(dqa);
  for (int t = 0; t < nt; ++t) {
    const int k0 = t * kTile, n = min(kTile, L - k0);
    float s[8][4] = {}, dp[8][4] = {};
    uint32_t live = 0;
    for (int i = 0; i < nd; ++i) {
      const int d0 = chunk_at(i, blockIdx.y, nd) * kC, wd = min(kC, Dh - d0);
      __syncthreads();  // every warp is done with the tiles
      load_chunk_async(qt, q, w.base, d0, w.row0, qn, HD, wd, vec, tid);
      load_chunk_async(dot, dout, w.base, d0, w.row0, qn, HD, wd, vec, tid);
      load_chunk_async(kt, k, w.base, d0, k0, n, HD, wd, vec, tid);
      load_chunk_async(vt, v, w.base, d0, k0, n, HD, wd, vec, tid);
      if (i == 0)
        for (int e = tid; e < n; e += kLongThreads) cp_async4(seg_s + e, seg + seg_b + k0 + e);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (i == 0)
#pragma unroll
        for (int jt = 0; jt < 8; ++jt)
          if (8 * jt < n && cols(own, seg_s, n, 8 * jt, l).live) live |= 1u << jt;
      wide_products_tiles(View{qt, kCs, qn, wd}, View{dot, kCs, qn, wd}, View{kt, kCs, n, wd},
                          View{vt, kCs, n, wd}, r0, (wd + 7) / 8, live, l, s, dp);
    }
    const View kc{kt, kCs, n, wc};
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      if (!(live >> jt & 1)) continue;
      const Cols c = cols(own, seg_s, n, 8 * jt, l);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = e & 1;
        const bool on = own.ok[r] && c.ok[i] && c.seg[i] == own.seg[r];
        ds[e] = on ? exp2f(fmaf(s[jt][e], c2, -lse2[r])) * (dp[jt][e] - di_r[r]) : 0.f;
      }
      const FragA da = acc_as_a(ds);
#pragma unroll
      for (int nn = 0; nn < kC / 8; ++nn) {
        if (8 * nn >= wc) break;
        mma3(dqa[nn], da, load_b_acc(kc, 8 * jt, 8 * nn, l));
      }
    }
  }
  store_acc<kC>(dq, w.base + c0, HD, w.row0 + r0, L, wc, dqa, scale, l);
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
                    fused_smem_bytes(a.L, a.H, a.Dh), s, a.q, a.k, a.v, a.seg, a.o, a.dout,
                    a.lse, a.dq, a.dk, a.dv, a.L, a.H, a.Dh, a.scale, vec);
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
      const bool vec = vec4 && ((int64_t)a.L * a.H * a.Dh) % 4 == 0;
      launch_kernel(flash_bwd_fused_kernel<DP, false, true>, (unsigned)a.B,
                    (a.L + 15) / 16 * 32, fused_smem_bytes(a.L, a.H, a.Dh), s, a.q, a.k, a.v,
                    a.seg, a.o, a.dout, a.lse, a.dq, a.dk, a.dv, a.L, a.H, a.Dh, a.scale, vec);
      return;
    }
    const bool vec = vec4 && a.Dh % 4 == 0;
    const dim3 grid((unsigned)((int64_t)a.B * ((a.L + kTile - 1) / kTile) * a.H),
                    (unsigned)chunks(a.Dh));
    if (which == kDkv)
      launch_kernel(flash_bwd_dkv_wide_kernel, grid, kLongThreads, wide_long_bytes(), s, a.q,
                    a.k, a.v, a.seg, a.dout, a.lse, a.di, a.dk, a.dv, a.L, a.H, a.Dh, a.scale,
                    vec);
    else
      launch_kernel(flash_bwd_dq_wide_kernel, grid, kLongThreads, wide_long_bytes(), s, a.q,
                    a.k, a.v, a.seg, a.dout, a.lse, a.di, a.dq, a.L, a.H, a.Dh, a.scale, vec);
  }
};

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
