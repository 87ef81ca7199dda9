// Flash attention forward with a segment-id mask, at any head dim, on the
// tensor cores at f32 accuracy.
//
// Replaces the TPU kernel that recommender_tpu/nn/transformer.py::_flash_mha
// reaches through jax.experimental.pallas.ops.tpu.flash_attention:
// _flash_attention_impl (jax 0.9.0, flash_attention.py:589), the forward,
// which saves the row log-sum-exp for the backward (flash_attention_bwd.cu).
// It computes the same function on every row the TPU kernel defines,
//
//     o[b, i, h, :] = sum_j softmax_j(scale * q[b,i,h,:] . k[b,j,h,:]) v[b,j,h,:]
//
// over the keys j with seg[b, j] == seg[b, i] (SegmentIds(seg, seg)), and
// lse[b, h, i], the natural log of the softmax's denominator. Every row sees
// itself, so no row is fully masked. Unlike the TPU wrapper it pads neither
// L to a 128-row block nor Dh to 128 lanes: the ragged edges are masked
// here, so `scale` is 1/sqrt(real Dh) and no inert padding position takes
// part.
//
// Layout: q, k, v, o f32 [B, L, H, Dh] (heads-last, contiguous); seg int32
// [B, L]; lse f32 [B, H, L].
//
// Two routes; ops/flash_attention.py::fwd_route picks one from (L, H, Dh):
// * fused (L <= 128 and fwd_smem_bytes(L, H, Dh) <= 227 KB; BST's
//   B1024 L101 H4 Dh9 takes it, 47,152 bytes a block): one block per batch
//   row holds all heads;
// * long (any other shape, e.g. the B128 L1001 probes): a block of 4 warps
//   owns 64 queries of one head and streams the keys in tiles of 64.
//
// What bounds it on an H100 80GB HBM3 (3.35 TB/s; TF32 tensor cores 495
// TFLOP/s, three TF32 products per f32 product, every pair the mask keeps
// counted; chip_smoke.py::k2_bounds):
// * BST: q, k, v, o, lse, seg 62 MB -> 18 us; ~3 GFLOP -> 6 us. Bytes.
// * B128 L1001 H4 Dh64: 0.53 GB -> 0.16 ms; 2.7e11 FLOP -> 0.54 ms.
//   Operations. At Dh 9 the same pairs: 0.08 ms of operations.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md): at
// BST 0.10 ms a launch on the device (chip_smoke.py --profile-bst; the
// earlier kernel 0.16 ms) and 0.12-0.14 ms alone by CUDA events (chip_smoke.py
// phase k2, where L1001 takes 0.86-0.89 ms at Dh9 and 2.25-2.29 ms at Dh64):
// 13-15% of the bound at BST, 9% and 24% at L1001. What holds it back: each
// 16 x 8 tile is a dependent chain of shared loads, splits, products and
// exp2 that the resident warps do not hide, and the fused block's copy in
// and out, which its own products do not overlap.
//
// What the design does about what held the earlier kernel (one query row per
// thread, FMA loops over shared rows) back:
// 1. Its inner loop was bound by shared-memory loads and two DPAD-long FMA
//    chains per key on the CUDA cores. Here S = Q K^T and O += P V are a
//    warp's mma.sync m16n8k8 on the TF32 tensor cores, split 3xTF32
//    (flash_mma.cuh) so the result keeps f32 accuracy where one TF32 product
//    keeps ~3 digits. A warp owns 16 query rows and keeps them, times scale
//    log2 e, as A fragments in registers; K and V rows are read from shared
//    memory once per 16 x 8 tile, through a base pointer of the lane and
//    constant offsets, with no bound check: the rows past L that a tile
//    reaches are zeros. Dh is padded to DP, a multiple of 8, in registers
//    only; where Dh % 8 is 1..4 (BST's 9) the last 8 columns of S take a
//    k = 4 product. P goes from S's accumulators straight into the A operand
//    of P V (acc_as_a), without shuffles.
// 2. It branched per key on the mask and on a rising max. Here the softmax
//    runs on the accumulator fragments a block of keys at a time: S of 8
//    tiles (64 keys), the block's row max over the four lanes of a quad, one
//    rescale of O and the row sum where the max rose, then P = 2^(S - m) by
//    one ex2.approx each. The mask of a block is taken once as bits (which
//    pairs of the lane, which tiles of the warp; the fused route takes it
//    once for all heads), and a 16 x 8 tile without a visible pair is
//    skipped. Holding a whole row of S (L <= 128) for an exact max first was
//    no faster than the online form (PERF.md).
// 3. Its blocks were (batch row, 64-query tile, head): at L 101 the second
//    tile was 37/64 full, and each head's block re-read the same rows. The
//    fused block holds one batch row: a warp per 16 queries (7 at L 101)
//    that walks the heads, so rows are padded to 112, not 128, and every
//    byte is read from device memory once.
// 4. Its loads were scalar, with a divide per element, into one buffer. The
//    fused block copies the q, k and v [L, H, Dh] spans of its batch row as
//    contiguous runs of 16-byte cp.async copies (4-byte where a span is not
//    16-byte aligned), assembles o in place of q and lse [H, L] in shared
//    memory, and writes both back as contiguous spans (16-byte stores where
//    aligned). The long route double-buffers its K and V tiles with
//    cp.async (16 bytes a copy where Dh % 4 == 0; no index divided by Dh),
//    so the next tile's copy runs under this one's products.
// 5. Head dims above 64 ("wide", flash_mma.cuh): Q no longer fits in
//    registers beside O, and the long route's double-buffered K and V tiles
//    would take 135 KB a block at Dh 128 (over 227 KB at 256). The first
//    wide kernels gave each block or warp one 64-column chunk of O and
//    computed S again for each chunk (1.5x the products at Dh 72 and 128,
//    2.5x at 256 on the long route), copied the long block's Q again at
//    every key tile and chunk, and waited for each copy at once. Now a warp
//    keeps O on a group of up to 4 chunks (256 columns) in registers
//    ("wide head dims" below): it computes S of a block of 64 keys once
//    over the whole Dh, runs the online softmax on S's accumulators and
//    takes P from them straight into O += P V, with no barrier between S
//    and P V. The long block (64 queries, 4 warps, two blocks an SM)
//    copies its Q once and streams K's and V's 64 x 64 chunks through a
//    ring of swizzled slots whose next copies run under each step's
//    products, one barrier a chunk; the fused block keeps its shared
//    memory and stages O over its q rows. Each tile's 8 chains of three
//    products run without a branch between them where the whole block of
//    keys is live: with one they ran one at a time, and the long kernel at
//    L 1001, Dh 128 took 9.6 ms, not 5.6 (k2_fwd_variants.py,
//    branch_per_tile).
//    Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase
//    k2, PERF.md): the L1001 probe at Dh 128, H 4: 5.6 ms alone (the
//    chunked kernel 10.9), 20% of its 1.09 ms (operations) bound, SDPA 7.9;
//    Dh 256, B 256, H 2: 0.30 ms long (0.72), 21% of its 0.063 ms (bytes)
//    bound; BST's rows with one head of Dh 128: 0.30 ms fused (0.61), 21%,
//    where the long kernel on the same inputs takes 0.25 (the fused block's
//    160 KB holds one block an SM); Dh 72: 0.17 ms fused (0.23).
//    cudaFuncGetAttributes and nvcc -Xptxas -v (chip_smoke.py --ptxas, the
//    same card): the wide long kernel 197 (NC 2) and 255 (NC 4) registers,
//    the wide fused kernel 169 and 255, no spills, no stack; the narrow
//    long kernel at DP 64 168 registers with 60 bytes of spill stores (its
//    limit of three blocks an SM).
// Each output element is written once, by one thread, with no atomics: every
// launch is bitwise deterministic.
//
// C interface for ctypes: pointers and the stream as void*; each entry
// returns cudaGetLastError() after its launch (cudaErrorInvalidValue for a
// shape its route does not take).

#include "flash_mma.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBlockTiles = 8;  // 16 x 8 tiles of S per softmax block
constexpr int kBlockKeys = 8 * kBlockTiles;
static_assert(kBlockTiles <= 8, "a Mask holds 4 bits for each of at most 8 tiles");
// Blocks per SM the long kernel asks registers for: five at DP <= 16
// (<= 102 registers; L1001 Dh9) and three above (<= 168; Dh64), each
// 3-6% faster than the compiler's own choice there (PERF.md). Each is set
// at compile time so that `chip_smoke.py --fwd-occupancy` can time it
// against 1. The fused kernel takes the compiler's choice: three blocks an
// SM were no faster at BST's shape.
#ifndef RTT_FWD_LONG_MIN_BLOCKS_NARROW
#define RTT_FWD_LONG_MIN_BLOCKS_NARROW 5
#endif
#ifndef RTT_FWD_LONG_MIN_BLOCKS_WIDE
#define RTT_FWD_LONG_MIN_BLOCKS_WIDE 3
#endif
constexpr int kLongMinBlocksNarrow = RTT_FWD_LONG_MIN_BLOCKS_NARROW;
constexpr int kLongMinBlocksWide = RTT_FWD_LONG_MIN_BLOCKS_WIDE;

__host__ __device__ constexpr int round8(int n) { return (n + 7) / 8 * 8; }

// Floats of one tensor's [L, H, Dh] span in the fused block: L rounded up
// to 8 rows of zeros, then fused_span's 16 zeros. The B reads of a 16 x 8
// tile reach row round8(L) - 1 and DP - Dh <= 15 floats past its last head's
// Dh without a bound check, and meet only these zeros.
__host__ __device__ constexpr int fwd_span(int L, int HD) { return fused_span(round8(L) * HD); }

// q, k, v spans, lse [H][L], seg [round8(L)]. Mirrored by
// ops/flash_attention.py.
int64_t fwd_smem_bytes(int L, int H, int Dh) {
  return 4 * (3LL * fwd_span(L, H * Dh) + (int64_t)H * L + round8(L));
}

// 2^x: one MUFU.EX2. Results below 2^-126 flush to 0; they are below any
// row sum's rounding (a row's largest term is 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of the 16 query rows a warp owns, of one head: the
// rows' seg and liveness, and for the lane's rows g and g + 8 the running
// max of the base-2 scores, the lane's share of the row sum (its columns 2t,
// 2t + 1 of every tile; the quad adds its four shares at the end) and O (DP
// columns of it), not yet divided by the sum.
template <int DP>
struct Online : RowSeg {
  float m[2], l[2];
  Acc<DP> o;

  __device__ __forceinline__ void init(const int* segs, int r0, int n, Lane ln) {
    set(segs, r0, n, ln);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
    zero<DP>(o);
  }

  // O / l into dst[row * stride + col] and, unless lse_dst is null, the
  // natural-log lse into lse_dst[row], for rows < n and columns < Dh (rows
  // r0 .. r0 + 15).
  __device__ __forceinline__ void store(float* dst, int stride, float* lse_dst, int r0, int n,
                                        int Dh, Lane ln) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];  // rows past n have nothing to store; their l may be 0
      const int row = r0 + ln.g + 8 * r;
      if (lse_dst != nullptr && ln.t == 0 && row < n)
        lse_dst[row] = (m[r] + log2f(l[r])) * kLn2;
    }
#pragma unroll
    for (int nn = 0; nn < DP / 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + ln.g + 8 * (e >> 1), col = 8 * nn + 2 * ln.t + (e & 1);
        if (row < n && col < Dh) dst[row * stride + col] = o[nn][e] * inv[e >> 1];
      }
  }
};

// The same rows with Q times scale log2 e as A fragments in registers (Dh <= 64).
template <int DP>
struct Query : Online<DP> {
  ARows<DP <= 32> q[DP / 8];

  __device__ __forceinline__ void load(const View& qv, const int* segs, int r0, int n,
                                       float c2, Lane ln) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) q[kk].set(qv, r0, 8 * kk, ln, c2);
    this->init(segs, r0, n, ln);
  }
};

// The segment mask over one softmax block of keys [k0, k0 + kBlockKeys):
// bit 4 jt + e of `on` is set where the lane's accumulator entry e of tile
// jt (rows g, g + 8 by columns 2t, 2t + 1) is a visible pair; bit jt of
// `live`, the same in every lane, where tile jt holds any. seg is read at
// every key below round8(n): the caller pads it.
struct Mask {
  uint32_t on, live;
};

__device__ __forceinline__ Mask block_mask(const RowSeg& w, const int* seg, int n, int k0,
                                           Lane ln) {
  Mask mk{0u, 0u};
#pragma unroll
  for (int jt = 0; jt < kBlockTiles; ++jt) {
    const int j0 = k0 + 8 * jt;
    if (j0 >= n) break;
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = j0 + 2 * ln.t + i, kseg = seg[j];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (w.ok[r] && j < n && kseg == w.seg[r]) bits |= 1u << (2 * r + i);
    }
    mk.on |= bits << (4 * jt);
    if (__any_sync(0xffffffffu, bits != 0)) mk.live |= 1u << jt;
  }
  return mk;
}

// The second half of a softmax block of keys, from its base-2 scores s
// (-inf where the mask hides a pair): the block's row max; O and the row sum
// rescaled once if it rose; then P = 2^(S - m) and O += P V over O's first
// nw groups of 8 columns. vp points at V(k0 + 2t, g) of the lane's head;
// rows are `stride` floats apart, and every row below the block's last live
// tile may be read.
template <int DP>
__device__ __forceinline__ void softmax_pv(Online<DP>& w, const float (&s)[kBlockTiles][4],
                                           const float* vp, int stride, Mask mk,
                                           int nw = DP / 8) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jt = 0; jt < kBlockTiles; ++jt)
    if (mk.live >> jt & 1)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[jt][e]);
  float base[2];  // the max each exponent is taken from
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if (mx[r] > w.m[r]) {  // the first visible key, or a higher one: rescale what was summed
      const float corr = ex2(w.m[r] - mx[r]);
      w.l[r] *= corr;
#pragma unroll
      for (int nn = 0; nn < DP / 8; ++nn) {
        w.o[nn][2 * r] *= corr;
        w.o[nn][2 * r + 1] *= corr;
      }
      w.m[r] = mx[r];
    }
    base[r] = w.m[r] == -INFINITY ? 0.f : w.m[r];  // no visible key yet: every S is -inf
  }
#pragma unroll
  for (int jt = 0; jt < kBlockTiles; ++jt) {
    if (!(mk.live >> jt & 1)) continue;
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = ex2(s[jt][e] - base[e >> 1]);
      w.l[e >> 1] += p[e];
    }
    const FragA pa = acc_as_a(p);
    const float* vr = vp + 8 * jt * stride;
#pragma unroll
    for (int nn = 0; nn < DP / 8; ++nn)
      if (nn < nw) mma3(w.o[nn], pa, split_b(vr[8 * nn], vr[stride + 8 * nn]));
  }
}

// One softmax block of keys: S of the warp's rows against its live tiles
// (base 2: Q carries scale log2 e), then softmax_pv. kp points at K(k0 + g,
// t) of the lane's head, vp at V(k0 + 2t, g).
template <int DP, bool kTail4>
__device__ __forceinline__ void attend(Query<DP>& w, const float* kp, const float* vp,
                                       int stride, Mask mk) {
  if (!mk.live) return;
  float s[kBlockTiles][4];
#pragma unroll
  for (int jt = 0; jt < kBlockTiles; ++jt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[jt][e] = -INFINITY;
    if (!(mk.live >> jt & 1)) continue;
    const float* kr = kp + 8 * jt * stride;
    Acc3 a;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const FragB b = split_b(kr[8 * kk], kr[8 * kk + 4]);
      if (kTail4 && kk == DP / 8 - 1)
        a.add_k4(w.q[kk].get(), b);
      else
        a.add(w.q[kk].get(), b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (mk.on >> (4 * jt + e) & 1) s[jt][e] = a.sum(e);
  }
  softmax_pv<DP>(w, s, vp, stride, mk);
}

// ------------------------------------------------------------ wide head dims
// Dh > 64 (flash_mma.cuh, "Head dims"). A warp owns 16 query rows and O on a
// group of NC chunks of kC columns (wide_group_chunks). It computes S of a
// block of 64 keys once over the whole Dh, runs the online softmax on S's
// accumulators and takes P from them straight into O += P V (acc_as_a),
// with no block barrier between S and P V.

// The online softmax of a warp's 16 query rows on a group of NC chunks: as
// Online, with O [NC][kC / 8][4] floats a lane.
template <int NC>
struct WideRows : RowSeg {
  float m[2], l[2];
  float o[NC][kC / 8][4];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int nn = 0; nn < kC / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[c][nn][e] = 0.f;
  }

  // 1 / l of the lane's rows g and g + 8 (the quad's shares added up) and,
  // unless lse_dst is null, the natural-log lse into lse_dst[row] for rows
  // r0 + g, r0 + g + 8 below n.
  __device__ __forceinline__ void finish(float (&inv)[2], float* lse_dst, int r0, int n,
                                         Lane ln) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];  // rows past n have nothing to store; their l may be 0
      const int row = r0 + ln.g + 8 * r;
      if (lse_dst != nullptr && ln.t == 0 && row < n) lse_dst[row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
};

// The softmax of one block of keys from its raw scores s (Q K^T): the
// base-2 scores c2 s, -inf where mk hides a pair; the block's row max; O and
// the row sum rescaled once if it rose; then P = 2^(S - m) in s on the live
// tiles, added to the row sums.
template <int NC>
__device__ __forceinline__ void wide_softmax(WideRows<NC>& w, float (&s)[kBlockTiles][4],
                                             Mask mk, float c2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jt = 0; jt < kBlockTiles; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[jt][e] = mk.on >> (4 * jt + e) & 1 ? s[jt][e] * c2 : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[jt][e]);
    }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if (mx[r] > w.m[r]) {
      const float corr = ex2(w.m[r] - mx[r]);
      w.l[r] *= corr;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int nn = 0; nn < kC / 8; ++nn) {
          w.o[c][nn][2 * r] *= corr;
          w.o[c][nn][2 * r + 1] *= corr;
        }
      w.m[r] = mx[r];
    }
    base[r] = w.m[r] == -INFINITY ? 0.f : w.m[r];
  }
#pragma unroll
  for (int jt = 0; jt < kBlockTiles; ++jt) {
    if (!(mk.live >> jt & 1)) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[jt][e] = ex2(s[jt][e] - base[e >> 1]);
      w.l[e >> 1] += s[jt][e];
    }
  }
}

// The inner loops below run S over every tile of a live block of keys (a
// tile the mask hides adds a product whose P is 0) and P V over every column
// group of a full chunk without a branch between them: the 8 independent
// chains of three products then interleave. A branch per tile or group left
// each chain to run alone (nvcc put one between every three products).

// The fused route's scores: acc[jt] += Q K^T over ng groups of 8 columns, Q
// the warp's 16 rows from r0 (A fragments read from shared memory, split
// once for the 8 tiles), K the 8 rows at 8 jt of k, every tile (rows past
// the keys read k's last one).
__device__ __forceinline__ void wide_scores(float (&acc)[kBlockTiles][4], const View& q,
                                            const View& k, int r0, int ng, Lane ln) {
  int kr[kBlockTiles];
#pragma unroll
  for (int jt = 0; jt < kBlockTiles; ++jt) kr[jt] = min(8 * jt + ln.g, k.rows - 1) * k.stride + ln.t;
  for (int kk = 0; kk < ng; ++kk) {
    const FragA a = load_a(q, r0, 8 * kk, ln);
#pragma unroll
    for (int jt = 0; jt < kBlockTiles; ++jt)
      mma3(acc[jt], a, split_b(k.p[kr[jt] + 8 * kk], k.p[kr[jt] + 8 * kk + 4]));
  }
}

// The fused route's O += P V over the group's first nw groups of 8 columns,
// the live tiles only: vp points at V(k0 + 2t, c0 + g) of the lane's head,
// rows `stride` floats apart; every row below the block's last live tile
// may be read.
template <int NC>
__device__ __forceinline__ void wide_pv_rows(WideRows<NC>& w, const float (&p)[kBlockTiles][4],
                                             uint32_t live, const float* vp, int stride,
                                             int nw) {
#pragma unroll
  for (int jt = 0; jt < kBlockTiles; ++jt) {
    if (!(live >> jt & 1)) continue;
    const FragA a = acc_as_a(p[jt]);
    const float* v0 = vp + 8 * jt * stride;
    const float* v1 = v0 + stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (8 * c + 8 <= nw) {
#pragma unroll
        for (int nn = 0; nn < kC / 8; ++nn)
          mma3(w.o[c][nn], a, split_b(v0[c * kC + 8 * nn], v1[c * kC + 8 * nn]));
      } else if (8 * c < nw) {
#pragma unroll
        for (int nn = 0; nn < kC / 8; ++nn)
          if (8 * c + nn < nw)
            mma3(w.o[c][nn], a, split_b(v0[c * kC + 8 * nn], v1[c * kC + 8 * nn]));
      }
    }
  }
}

// The long route's O_c += P X over the block's 64 keys, the live tiles only:
// X the first nw groups of 8 columns of a swizzled chunk tile of V, read in
// load_b_acc's order. Rows 8 jt + 2 t and 8 jt + 2 t + 1 swizzle by 8 t and
// 8 t + 4, so group nn sits at 32 (nn / 4) + 8 ((nn % 4) ^ t) + g (g ^ 4):
// four lane pointers a row, and immediate offsets from them.
__device__ __forceinline__ void wide_pv_swz(float (&o)[kC / 8][4],
                                            const float (&p)[kBlockTiles][4], uint32_t live,
                                            const float* x, int nw, Lane ln) {
  const float* x0[4];
  const float* x1[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    x0[b] = x + 2 * ln.t * kC + ln.g + 8 * (b ^ ln.t);
    x1[b] = x + (2 * ln.t + 1) * kC + (ln.g ^ 4) + 8 * (b ^ ln.t);
  }
#pragma unroll
  for (int jt = 0; jt < kBlockTiles; ++jt) {
    if (!(live >> jt & 1)) continue;
    const FragA a = acc_as_a(p[jt]);
    const int row = 8 * jt * kC;
    if (nw == kC / 8) {
#pragma unroll
      for (int nn = 0; nn < kC / 8; ++nn)
        mma3(o[nn], a, split_b(x0[nn & 3][row + 32 * (nn >> 2)], x1[nn & 3][row + 32 * (nn >> 2)]));
    } else {
#pragma unroll
      for (int nn = 0; nn < kC / 8; ++nn)
        if (nn < nw)
          mma3(o[nn], a,
               split_b(x0[nn & 3][row + 32 * (nn >> 2)], x1[nn & 3][row + 32 * (nn >> 2)]));
    }
  }
}

// n floats from shared memory to device memory, 16 bytes a store where vec.
__device__ __forceinline__ void store_span(float* __restrict__ dst, const float* src, int n,
                                           bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < n / 4; e += blockDim.x)
      reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(src)[e];
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
  }
}

// ------------------------------------------------------------ fused route
// One block per batch row b, one warp per 16 queries (L rounded up to 16).
// The warp takes the segment mask of its queries once, then walks the heads,
// and writes each head's O over its own q rows of that head. NC > 0 (Dh >
// 64, DP = kC): per head and group of NC chunks (wide_groups), the
// warp computes S of each block of keys once over every column of Q and K,
// read from shared memory, and O += P V on the group's columns in
// registers. With one group, O goes over the warp's q rows of the head as
// the narrow kernel's does; with more, later groups still read q, so O goes
// straight to device memory.
template <int DP, bool kTail4, int NC = 0>
__global__ void __launch_bounds__(kFusedMaxL / 16 * 32)
flash_fwd_fused_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const int* __restrict__ seg,
                       float* __restrict__ o, float* __restrict__ lse, int L, int H, int Dh,
                       float scale, bool vec, bool vec_lse) {
  constexpr int kBlocks = kFusedMaxL / kBlockKeys;
  extern __shared__ float4 smem[];
  const int HD = H * Dh, n = L * HD, n4 = fwd_span(L, HD);
  float* qs = reinterpret_cast<float*>(smem);  // then o
  float* ks = qs + n4;
  float* vs = ks + n4;
  float* lse_s = vs + n4;  // [H][L]
  int* seg_s = reinterpret_cast<int*>(lse_s + H * L);  // [round8(L)]
  const int b = blockIdx.x, tid = threadIdx.x, nthreads = blockDim.x;
  const int64_t base = (int64_t)b * n;

  const float* src[3] = {q + base, k + base, v + base};
  float* to[3] = {qs, ks, vs};
  if (vec) {
    for (int e = tid; e < n / 4; e += nthreads)
#pragma unroll
      for (int m = 0; m < 3; ++m) cp_async16(to[m] + 4 * e, src[m] + 4 * e);
  } else {
    for (int e = tid; e < n; e += nthreads)
#pragma unroll
      for (int m = 0; m < 3; ++m) cp_async4(to[m] + e, src[m] + e);
  }
  for (int e = tid; e < L; e += nthreads) cp_async4(seg_s + e, seg + (int64_t)b * L + e);
  cp_async_commit();
  for (int e = n + tid; e < n4; e += nthreads)  // the rows past L, and the tail
#pragma unroll
    for (int m = 0; m < 3; ++m) to[m][e] = 0.f;
  for (int e = L + tid; e < round8(L); e += nthreads) seg_s[e] = 0;
  cp_async_wait<0>();
  __syncthreads();

  const Lane ln = lane();
  const int r0 = 16 * (tid >> 5);
  const float c2 = scale * kLog2e;
  if constexpr (NC > 0) {
    WideRows<NC> w;
    w.set(seg_s, r0, L, ln);
    Mask mk[kBlocks];
#pragma unroll
    for (int i = 0; i < kBlocks; ++i)
      mk[i] = i * kBlockKeys < L ? block_mask(w, seg_s, L, i * kBlockKeys, ln) : Mask{0u, 0u};
    const int ng = (Dh + 7) / 8, groups = wide_groups(Dh);
    for (int h = 0; h < H; ++h) {
      const View qv{qs + h * Dh, HD, L, Dh};
      for (int gi = 0; gi < groups; ++gi) {
        const int c0 = gi * NC * kC, nw = (min(NC * kC, Dh - c0) + 7) / 8;
        w.reset();
#pragma unroll
        for (int i = 0; i < kBlocks; ++i) {
          if (!mk[i].live) continue;
          const int k0 = i * kBlockKeys;
          float s[kBlockTiles][4] = {};
          wide_scores(s, qv, View{ks + h * Dh + k0 * HD, HD, L - k0, Dh}, r0, ng, ln);
          wide_softmax(w, s, mk[i], c2);
          wide_pv_rows(w, s, mk[i].live, vs + h * Dh + c0 + (k0 + 2 * ln.t) * HD + ln.g, HD, nw);
        }
        float inv[2];
        w.finish(inv, gi == 0 ? lse_s + h * L : nullptr, r0, L, ln);
        // one group: O over the warp's own q rows of head h, once every
        // lane has read them; else straight to device memory
        if (groups == 1) __syncwarp();
        float* dst = groups == 1 ? qs + h * Dh : o + base + h * Dh + c0;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int nn = 0; nn < kC / 8; ++nn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = r0 + ln.g + 8 * (e >> 1);
              const int col = c * kC + 8 * nn + 2 * ln.t + (e & 1);
              if (row < L && c0 + col < Dh) dst[row * HD + col] = w.o[c][nn][e] * inv[e >> 1];
            }
      }
    }
    __syncthreads();
    if (groups == 1) store_span(o + base, qs, n, vec);
    store_span(lse + (int64_t)b * H * L, lse_s, H * L, vec_lse);
    return;
  }
  Query<DP> w;
  w.load(View{qs, HD, L, Dh}, seg_s, r0, L, c2, ln);  // the seg of the warp's rows
  Mask mk[kBlocks];
#pragma unroll
  for (int i = 0; i < kBlocks; ++i)
    mk[i] = i * kBlockKeys < L ? block_mask(w, seg_s, L, i * kBlockKeys, ln) : Mask{0u, 0u};
  for (int h = 0; h < H; ++h) {
    if (h > 0) w.load(View{qs + h * Dh, HD, L, Dh}, seg_s, r0, L, c2, ln);
    const float* kp = ks + h * Dh + ln.g * HD + ln.t;
    const float* vp = vs + h * Dh + 2 * ln.t * HD + ln.g;
#pragma unroll
    for (int i = 0; i < kBlocks; ++i)
      attend<DP, kTail4>(w, kp + i * kBlockKeys * HD, vp + i * kBlockKeys * HD, HD, mk[i]);
    __syncwarp();  // every lane has read its q rows of head h
    w.store(qs + h * Dh, HD, lse_s + h * L, r0, L, Dh, ln);
  }
  __syncthreads();
  store_span(o + base, qs, n, vec);
  store_span(lse + (int64_t)b * H * L, lse_s, H * L, vec_lse);
}

// ------------------------------------------------------------ long route
// Shared memory of a long-route block: two stages of a K and a V tile,
// [kTile][Long<DP>::kRs] each, and seg [2][kTile]. The block's queries are
// copied into the second stage's K tile first and read from there before
// tile 1 is; O is assembled in the first stage at the end.
template <int DP>
__host__ __device__ constexpr int64_t long_bytes() {
  return 4 * (4LL * Long<DP>::kTileFloats + 2LL * kTile);
}

// O and lse of the block's 64 queries of one head; the keys and values
// stream through in tiles of 64.
template <int DP, bool kTail4>
__global__ void __launch_bounds__(kLongThreads,
                                  DP <= 16 ? kLongMinBlocksNarrow : kLongMinBlocksWide)
flash_fwd_long_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ seg,
                      float* __restrict__ o, float* __restrict__ lse, int L, int H, int Dh,
                      float scale, bool vec) {
  constexpr int RS = Long<DP>::kRs, TF = Long<DP>::kTileFloats;
  extern __shared__ float4 smem[];
  float* tiles = reinterpret_cast<float*>(smem);  // stage i: K at 2i TF, V at (2i + 1) TF
  int* seg_s = reinterpret_cast<int*>(tiles + 4 * TF);  // [2][kTile]
  const Where w = where(L, H, Dh);
  const int HD = H * Dh, tid = threadIdx.x, r0 = 16 * (tid >> 5);
  const int qn = min(kTile, L - w.row0);
  const int nt = (L + kTile - 1) / kTile;
  const int64_t seg_b = (int64_t)w.b * L;
  const Lane ln = lane();

  // zeros wherever a copy does not write and a B read may go: the pad
  // columns, and the rows past L of a last tile
  for (int e = tid; e < (int)(long_bytes<DP>() / 16); e += kLongThreads)
    smem[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  auto prefetch = [&](int t) {
    const int buf = t & 1, k0 = t * kTile, n = min(kTile, L - k0);
    float* st = tiles + 2 * buf * TF;
    load_tile_async<DP, RS>(st, k, w.base, k0, n, HD, Dh, vec, tid);
    load_tile_async<DP, RS>(st + TF, v, w.base, k0, n, HD, Dh, vec, tid);
    for (int e = tid; e < n; e += kLongThreads)
      cp_async4(seg_s + buf * kTile + e, seg + seg_b + k0 + e);
    cp_async_commit();
  };
  load_tile_async<DP, RS>(tiles + 2 * TF, q, w.base, w.row0, qn, HD, Dh, vec, tid);
  prefetch(0);  // one group with the block's queries
  cp_async_wait<0>();
  __syncthreads();
  const float c2 = scale * kLog2e;
  Query<DP> wq;
  wq.load(View{tiles + 2 * TF, RS, qn, Dh}, seg + seg_b + w.row0, r0, qn, c2, ln);
  __syncthreads();  // before tile 1 lands on the queries

  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) prefetch(t + 1);
    if (t > 0) {
      if (t + 1 < nt)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
    }
    const int buf = t & 1, n = min(kTile, L - t * kTile);
    if (r0 < qn) {
      const float* kp = tiles + 2 * buf * TF + ln.g * RS + ln.t;
      const float* vp = tiles + (2 * buf + 1) * TF + 2 * ln.t * RS + ln.g;
      attend<DP, kTail4>(wq, kp, vp, RS, block_mask(wq, seg_s + buf * kTile, n, 0, ln));
    }
    __syncthreads();  // before this buffer is loaded again
  }
  wq.store(tiles, RS, lse + w.rows + w.row0, r0, qn, Dh, ln);
  __syncthreads();
  if (vec) {
    const int cpr = Dh >> 2;
    for (int e = tid; e < qn * cpr; e += kLongThreads) {
      const int r = e / cpr, c = (e - r * cpr) << 2;
      *reinterpret_cast<float4*>(o + w.base + (int64_t)(w.row0 + r) * HD + c) =
          *reinterpret_cast<const float4*>(tiles + r * RS + c);
    }
  } else {
    for (int e = tid; e < qn * Dh; e += kLongThreads) {
      const int r = e / Dh, c = e - r * Dh;
      o[w.base + (int64_t)(w.row0 + r) * HD + c] = tiles[r * RS + c];
    }
  }
}

// ------------------------------------------------------------ wide long route
// A block owns 64 queries of one head and O on its group of NC chunks (grid
// y: wide_groups). Its shared memory is slots of one swizzled 64 x 64
// chunk tile each (kSwzTile floats) and seg [2][kTile]: the block's Q, its nd
// chunks copied once, then a ring of R = slots - nd K and V chunks; where Q
// does not fit (nd > NC, Dh > 256), its chunks stream through a ring of
// every slot, each beside K's.
//
// For each tile of 64 keys the block takes nd steps, S += Q_d K_d^T over
// chunk d, then the softmax in registers, then NC steps, O_c += P V_c. The
// ring's schedule: the tile's copies, in the order the steps use them, are
// for each chunk d Q's (where Q streams) and K's, then V's chunks of the
// group; copy i goes to ring slot i % R and, with a tile's first copy, the
// tile's seg to seg buffer t % 2. Each copy is one cp.async group. A step
// waits for its own last copy, then at one barrier, which also tells that
// every warp is done with the step before and its slots, issues the copies
// up to the one that takes that step's last slot: R - 1 copies (R - 2 where a
// step reads Q's and K's) stay in flight under each step's products.
// Mirrored and simulated over Dh 65-599 by
// tests/test_torch_flash_attention.py::test_wide_fwd_ring_schedule.
//
// Slots: 6 where NC = 2 (96 KB) and 7 where NC = 4 (112 KB), so that two
// blocks of 4 warps share an SM (each with the 1 KB the card reserves a
// block); two blocks give a thread up to 255 registers, which hold O on 4
// chunks (128 floats a lane) and S without spilling. Three blocks at NC = 2
// (a ring of 2, at most 168 registers) ran 7% faster at L 1001 but spilled
// 20 bytes a thread (k2_fwd_variants.py, three_blocks); a block of 8 warps
// on 128 queries, which halves the copies, was slower in a trial build.
__host__ __device__ constexpr int wide_fwd_slots(int NC) { return NC == 2 ? 6 : 7; }

__host__ __device__ constexpr int64_t wide_fwd_smem_bytes(int NC) {
  return 4LL * (wide_fwd_slots(NC) * kSwzTile + 2 * kTile);
}

template <int NC>
__global__ void __launch_bounds__(kLongThreads, 2)
flash_fwd_wide_long_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const int* __restrict__ seg,
                           float* __restrict__ o, float* __restrict__ lse, int L, int H,
                           int Dh, float scale, bool vec) {
  extern __shared__ float4 smem[];
  float* slots = reinterpret_cast<float*>(smem);
  int* seg_s = reinterpret_cast<int*>(slots + wide_fwd_slots(NC) * kSwzTile);  // [2][kTile]
  const Where w = where(L, H, Dh);
  const int HD = H * Dh, tid = threadIdx.x, r0 = 16 * (tid >> 5);
  const int qn = min(kTile, L - w.row0), nt = (L + kTile - 1) / kTile;
  const int nd = chunks(Dh), g0 = blockIdx.y * NC, ngc = min(NC, nd - g0);
  const bool q_stream = nd > NC;
  const int R = wide_fwd_slots(NC) - (q_stream ? 0 : nd);
  float* ring = slots + (q_stream ? 0 : nd) * kSwzTile;
  const int take = q_stream ? 2 : 1;  // the copies of an S step: Q's (where it streams), K's
  const int kd = take * nd, per_tile = kd + ngc, total = nt * per_tile;
  const int64_t seg_b = (int64_t)w.b * L;
  const Lane ln = lane();

  if (!q_stream) {
    for (int d = 0; d < nd; ++d)
      load_swz_async(slots + d * kSwzTile, q, w.base + d * kC, w.row0, qn, HD,
                     min(kC, Dh - d * kC), vec, tid, kLongThreads);
    cp_async_commit();
  }
  int issued = 0, lt = 0, lk = 0;  // copies issued; the next one's tile and place in it
  auto issue = [&](int upto) {
    for (; issued <= upto && issued < total; ++issued) {
      const int k0 = lt * kTile, n = min(kTile, L - k0);
      const float* x = k;
      int d0, row0 = k0, rows = n;
      if (lk >= kd) {
        d0 = (g0 + lk - kd) * kC;
        x = v;
      } else if (q_stream) {  // Q's chunk d, then K's
        d0 = (lk >> 1) * kC;
        if (!(lk & 1)) {
          x = q;
          row0 = w.row0;
          rows = qn;
        }
      } else {
        d0 = lk * kC;
      }
      load_swz_async(ring + (issued % R) * kSwzTile, x, w.base + d0, row0, rows, HD,
                     min(kC, Dh - d0), vec, tid, kLongThreads);
      if (lk == 0)
        for (int e = tid; e < n; e += kLongThreads)
          cp_async4(seg_s + (lt & 1) * kTile + e, seg + seg_b + k0 + e);
      cp_async_commit();
      if (++lk == per_tile) {
        lk = 0;
        ++lt;
      }
    }
  };
  int last = -1;  // the last copy the steps so far read
  // a step that reads `take` copies: returns the first one's index
  auto step = [&](int take) {
    const int first = last + 1;
    cp_async_wait_n(issued - 1 - (last + take));
    __syncthreads();
    issue(last + R);
    last += take;
    return first;
  };
  issue(R - 1);

  const float c2 = scale * kLog2e;
  WideRows<NC> st;
  st.set(seg + seg_b + w.row0, r0, qn, ln);
  st.reset();
  bool every[kBlockTiles];  // S of every tile of a live block (see wide_scores)
#pragma unroll
  for (int jt = 0; jt < kBlockTiles; ++jt) every[jt] = true;
  for (int t = 0; t < nt; ++t) {
    const int n = min(kTile, L - t * kTile);
    float s[kBlockTiles][4] = {};  // S, then P
    Mask mk{0u, 0u};
    for (int d = 0; d < nd; ++d) {
      const int u = step(take);
      if (d == 0) mk = block_mask(st, seg_s + (t & 1) * kTile, n, 0, ln);
      if (mk.live) {
        const float* qt = q_stream ? ring + (u % R) * kSwzTile : slots + d * kSwzTile;
        const float* kt = ring + ((u + take - 1) % R) * kSwzTile;
        wide_score_products<kBlockTiles>(qt, kt, r0, 0, (min(kC, Dh - d * kC) + 7) / 8, every,
                                         ln, s);
      }
    }
    wide_softmax(st, s, mk, c2);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c >= ngc) break;
      const int u = step(1);
      if (mk.live)
        wide_pv_swz(st.o[c], s, mk.live, ring + (u % R) * kSwzTile,
                    (min(kC, Dh - (g0 + c) * kC) + 7) / 8, ln);
    }
  }
  // O / l into slots 0 .. ngc - 1 once every warp is done with them (no
  // copy is pending), then to device memory as rows of 16-byte pieces
  float inv[2];
  st.finish(inv, blockIdx.y == 0 ? lse + w.rows + w.row0 : nullptr, r0, qn, ln);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int nn = 0; nn < kC / 8; ++nn)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (c >= ngc) break;
        const int row = r0 + ln.g + 8 * r;
        *reinterpret_cast<float2*>(slots + c * kSwzTile + swz(row, 8 * nn + 2 * ln.t)) =
            make_float2(st.o[c][nn][2 * r] * inv[r], st.o[c][nn][2 * r + 1] * inv[r]);
      }
  __syncthreads();
  for (int c = 0; c < ngc; ++c) {
    const int c0 = (g0 + c) * kC, wc = min(kC, Dh - c0);
    const float* src = slots + c * kSwzTile;
    float* dst = o + w.base + c0 + (int64_t)w.row0 * HD;
    if (vec) {
      const int cpr = wc >> 2;
      for (int e = tid; e < qn * cpr; e += kLongThreads) {
        const int r = e / cpr, col = (e - r * cpr) << 2;
        *reinterpret_cast<float4*>(dst + (int64_t)r * HD + col) =
            *reinterpret_cast<const float4*>(src + swz(r, col));
      }
    } else {
      for (int e = tid; e < qn * wc; e += kLongThreads) {
        const int r = e / wc, col = e - r * wc;
        dst[(int64_t)r * HD + col] = src[swz(r, col)];
      }
    }
  }
}

// ------------------------------------------------------------ host side
struct Args {
  const float *q, *k, *v;
  const int* seg;
  float *o, *lse;
  int B, L, H, Dh;
  float scale;
};

enum Which { kFused, kLong };

template <int DP, bool kTail4>
struct Launch {
  static void run(const Which& which, const Args& a, const cudaStream_t& s) {
    const bool vec4 = aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.o);
    if (which == kFused) {
      const bool vec = vec4 && ((int64_t)a.L * a.H * a.Dh) % 4 == 0;
      const bool vec_lse = aligned16(a.lse) && (a.H * a.L) % 4 == 0;
      launch_kernel(flash_fwd_fused_kernel<DP, kTail4>, (unsigned)a.B, (a.L + 15) / 16 * 32,
                    fwd_smem_bytes(a.L, a.H, a.Dh), s, a.q, a.k, a.v, a.seg, a.o, a.lse, a.L,
                    a.H, a.Dh, a.scale, vec, vec_lse);
      return;
    }
    const unsigned grid = (unsigned)((int64_t)a.B * ((a.L + kTile - 1) / kTile) * a.H);
    launch_kernel(flash_fwd_long_kernel<DP, kTail4>, grid, kLongThreads, long_bytes<DP>(), s,
                  a.q, a.k, a.v, a.seg, a.o, a.lse, a.L, a.H, a.Dh, a.scale,
                  vec4 && a.Dh % 4 == 0);
  }

  // Dh > 64: groups of 2 or 4 chunks of kC = DP columns
  static void run_wide(const Which& which, const Args& a, const cudaStream_t& s) {
    if (wide_group_chunks(a.Dh) == 2)
      run_group<2>(which, a, s);
    else
      run_group<4>(which, a, s);
  }

  template <int NC>
  static void run_group(Which which, const Args& a, cudaStream_t s) {
    const bool vec4 = aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.o);
    if (which == kFused) {
      const bool vec = vec4 && ((int64_t)a.L * a.H * a.Dh) % 4 == 0;
      const bool vec_lse = aligned16(a.lse) && (a.H * a.L) % 4 == 0;
      launch_kernel(flash_fwd_fused_kernel<DP, false, NC>, (unsigned)a.B, (a.L + 15) / 16 * 32,
                    fwd_smem_bytes(a.L, a.H, a.Dh), s, a.q, a.k, a.v, a.seg, a.o, a.lse, a.L,
                    a.H, a.Dh, a.scale, vec, vec_lse);
      return;
    }
    const dim3 grid((unsigned)((int64_t)a.B * ((a.L + kTile - 1) / kTile) * a.H),
                    (unsigned)wide_groups(a.Dh));
    launch_kernel(flash_fwd_wide_long_kernel<NC>, grid, kLongThreads, wide_fwd_smem_bytes(NC), s,
                  a.q, a.k, a.v, a.seg, a.o, a.lse, a.L, a.H, a.Dh, a.scale,
                  vec4 && a.Dh % 4 == 0);
  }
};

// Registers, local memory bytes a thread and blocks an SM (out[0..2]) of the
// wide forward kernel of (L, H, Dh)'s group, fused or long, as its launch
// configures it.
template <int NC>
int wide_info(bool fused, int L, int H, int Dh, int* out) {
  if (!fused) {
    kernel_info(flash_fwd_wide_long_kernel<NC>, kLongThreads, wide_fwd_smem_bytes(NC), out);
    return 0;
  }
  if (L > kFusedMaxL || fwd_smem_bytes(L, H, Dh) > kMaxSmem) return (int)cudaErrorInvalidValue;
  kernel_info(flash_fwd_fused_kernel<kC, false, NC>, (L + 15) / 16 * 32, fwd_smem_bytes(L, H, Dh),
              out);
  return 0;
}

int dispatch(Which which, const void* q, const void* k, const void* v, const void* seg,
             void* o, void* lse, int B, int L, int H, int Dh, float scale, void* stream) {
  if (!shape_ok(B, L, H, Dh)) return (int)cudaErrorInvalidValue;
  if (which == kFused && (L > kFusedMaxL || fwd_smem_bytes(L, H, Dh) > kMaxSmem))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.seg = static_cast<const int*>(seg);
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.B = B; a.L = L; a.H = H; a.Dh = Dh; a.scale = scale;
  by_head_dim<Launch>(Dh, which, a, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the fused route needs for one batch row (as fwd_route counts it).
extern "C" long long rtt_flash_attention_fwd_fused_smem(int L, int H, int Dh) {
  return fwd_smem_bytes(L, H, Dh);
}

// Fused route: o [B, L, H, Dh] and lse [B, H, L] (natural log).
extern "C" int rtt_flash_attention_fwd_fused(const void* q, const void* k, const void* v,
                                             const void* seg, void* o, void* lse, int B, int L,
                                             int H, int Dh, float scale, void* stream) {
  return dispatch(kFused, q, k, v, seg, o, lse, B, L, H, Dh, scale, stream);
}

// Long route: the same outputs from the same inputs.
extern "C" int rtt_flash_attention_fwd_long(const void* q, const void* k, const void* v,
                                            const void* seg, void* o, void* lse, int B, int L,
                                            int H, int Dh, float scale, void* stream) {
  return dispatch(kLong, q, k, v, seg, o, lse, B, L, H, Dh, scale, stream);
}

// The wide forward's column groups at Dh (the long route's blocks in grid y;
// 0 for Dh <= 64), as ops/flash_attention.py::wide_fwd_groups counts them.
extern "C" int rtt_flash_attention_fwd_wide_groups(int Dh) {
  return Dh > kNarrowMaxDh ? wide_groups(Dh) : 0;
}

// Registers, local memory bytes a thread and blocks an SM (out[0..2]) of the
// wide forward kernel (Dh > 64) of the fused (fused != 0) or the long route,
// as its launch at [., L, H, Dh] configures it (the long kernel's does not
// depend on L and H; the fused block's threads and shared memory do).
extern "C" int rtt_flash_attention_fwd_wide_info(int fused, int L, int H, int Dh, int* out) {
  if (Dh <= kNarrowMaxDh || L < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const int err = wide_group_chunks(Dh) == 2 ? wide_info<2>(fused != 0, L, H, Dh, out)
                                                 : wide_info<4>(fused != 0, L, H, Dh, out);
  return err != 0 ? err : (int)cudaGetLastError();
}
