// Pieces shared by K2's forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu): cp.async copies, 3xTF32 mma.sync products at
// f32 accuracy, fragment loads from shared memory, the long routes' tiles
// and block index, the wide head dims' column chunks, and the launch.
//
// Head dims. Dh <= 64 is padded to DP, a multiple of 8, and a warp keeps
// its own 16 rows as A fragments and its outputs as accumulators in
// registers (by_head_dim). Dh > 64 ("wide") would not fit there: at DP 128
// the rows and the accumulators alone take ~200 registers, and a long
// block's double-buffered 64-row tiles 135 KB (over 227 KB at 256). So a
// wide Dh is cut into chunks of kC = 64 columns. The products over Dh (S =
// Q K^T, dP = dO V^T) add up chunk by chunk, their A rows read from shared
// memory, once per streamed tile for a group of up to 4 output chunks (256
// columns), whose accumulators a warp keeps in registers: the long
// forward's and the long backward's blocks and the fused forward's warps
// own such a group (flash_attention.cu, "wide head dims";
// flash_attention_bwd.cu, "wide long route"). The long routes and the fused
// backward stream their chunks through a ring of swizzled 64-column tiles
// (swz, load_swz_async) whose copies stay in flight under the products; the
// fused backward computes S and dP once per (batch row, head), its sums in
// registers and P^T, then dS^T, in shared memory (flash_attention_bwd.cu,
// "wide fused route"). Shared memory and registers do not grow with Dh:
// any Dh >= 1 runs.
//
// Layout of every tensor as the kernels see it: q, k, v, o and their
// gradients f32 [B, L, H, Dh] (heads-last, contiguous); seg int32 [B, L];
// per-row vectors (lse, di) f32 [B, H, L].
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kFusedMaxL = 128;  // fused routes: the longest sequence one block holds
constexpr int kTile = 64;        // long routes: rows per block and per streamed tile
constexpr int kLongThreads = kTile / 16 * 32;
constexpr int64_t kMaxSmem = 232448;  // the most shared memory one block may use
constexpr int kNarrowMaxDh = 64;      // by_head_dim's widest padding; above it, chunks
constexpr int kC = 64;                // wide head dims: columns of a chunk

// Floats of one tensor's [L, H, Dh] span of n in a fused route: rounded up
// to 16 bytes, then 16 zeros. B reads of the last row reach DP - Dh <= 15
// floats past its Dh, and meet only these zeros.
__host__ __device__ constexpr int fused_span(int n) { return (n + 3) / 4 * 4 + 16; }

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

template <int DP>
using Acc = float[DP / 8][4];

template <int DP>
__device__ __forceinline__ void zero(Acc<DP>& acc) {
#pragma unroll
  for (int nn = 0; nn < DP / 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;
}

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

// A[m][k] = mul * X(r0 + m, c0 + k): 16 rows of X as the A operand
__device__ __forceinline__ FragA load_a(const View& x, int r0, int c0, Lane l, float mul = 1.f) {
  return split_a(mul * x(r0 + l.g, c0 + l.t), mul * x(r0 + l.g + 8, c0 + l.t),
                 mul * x(r0 + l.g, c0 + l.t + 4), mul * x(r0 + l.g + 8, c0 + l.t + 4));
}

// A warp's own rows, times mul, as A fragments (load_a), one per 8 columns:
// split once (kSplit: 8 registers a fragment), or kept in f32 and split at
// each use (4 registers).
template <bool kSplit>
struct ARows;

template <>
struct ARows<true> {
  FragA f;
  __device__ __forceinline__ void set(const View& x, int r0, int c0, Lane l, float mul = 1.f) {
    f = load_a(x, r0, c0, l, mul);
  }
  __device__ __forceinline__ FragA get() const { return f; }
};

template <>
struct ARows<false> {
  float x[4];
  __device__ __forceinline__ void set(const View& v, int r0, int c0, Lane l, float mul = 1.f) {
    x[0] = mul * v(r0 + l.g, c0 + l.t);
    x[1] = mul * v(r0 + l.g + 8, c0 + l.t);
    x[2] = mul * v(r0 + l.g, c0 + l.t + 4);
    x[3] = mul * v(r0 + l.g + 8, c0 + l.t + 4);
  }
  __device__ __forceinline__ FragA get() const { return split_a(x[0], x[1], x[2], x[3]); }
};

// The segment ids of a warp's lane rows g and g + 8 (of its 16 rows from
// r0), and whether each is below n.
struct RowSeg {
  int seg[2];
  bool ok[2];
  __device__ __forceinline__ void set(const int* segs, int r0, int n, Lane l) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + l.g + 8 * r;
      ok[r] = row < n;
      seg[r] = ok[r] ? segs[row] : 0;
    }
  }
};

// ------------------------------------------------------------ long routes
// A block owns kTile rows of one head and streams the other side's rows in
// tiles of kTile, [kTile][kRs] floats each in shared memory.
template <int DP>
struct Long {
  static constexpr int kRs = DP + 4;  // 4 mod 8: A and B reads hit 32 banks
  static constexpr int kTileFloats = kTile * kRs;
};

// Rows [row0, row0 + n) of one head of a [B, L, H, Dh] tensor (base is the
// offset of (b, 0, h, 0)) into dst[r * RS + c], c < Dh, by cp.async. Each
// thread takes one column piece of every kStep-th row: 16 bytes where vec
// (Dh % 4 == 0 and 16-byte aligned pointers), else 4; no index is divided
// by Dh.
template <int DP, int RS, int kThreads = kLongThreads>
__device__ __forceinline__ void load_tile_async(float* dst, const float* __restrict__ x,
                                                int64_t base, int row0, int n, int HD,
                                                int Dh, bool vec, int tid) {
  if (vec) {
    constexpr int kW = DP / 4, kStep = kThreads / kW;
    const int c = tid % kW * 4;
    if (tid < kStep * kW && c < Dh)
      for (int r = tid / kW; r < n; r += kStep)
        cp_async16(dst + r * RS + c, x + base + (int64_t)(row0 + r) * HD + c);
  } else {
    constexpr int kStep = kThreads / DP;
    const int c = tid % DP;
    if (tid < kStep * DP && c < Dh)
      for (int r = tid / DP; r < n; r += kStep)
        cp_async4(dst + r * RS + c, x + base + (int64_t)(row0 + r) * HD + c);
  }
}

// ------------------------------------------------------------ wide head dims
__host__ __device__ constexpr int chunks(int Dh) { return (Dh + kC - 1) / kC; }

// Column groups: a warp of the wide forward and of the long backward keeps
// its outputs on a group of 2 chunks where Dh <= 128, else 4 (256 columns;
// 128 floats of O a lane in the forward), and computes the products over
// Dh once per group: the long routes' grid y counts the groups, the fused
// forward's warps loop over them. Once up to Dh 256, twice at 257-512.
// Mirrored by ops/flash_attention.py::wide_fwd_groups and wide_bwd_groups.
__host__ __device__ constexpr int wide_group_chunks(int Dh) { return chunks(Dh) <= 2 ? 2 : 4; }

__host__ __device__ constexpr int wide_groups(int Dh) {
  return (chunks(Dh) + wide_group_chunks(Dh) - 1) / wide_group_chunks(Dh);
}

constexpr int kSwzTile = kTile * kC;  // floats of a swizzled chunk tile

// A chunk tile without pad: element (r, c) at r * kC + (c ^ 4 (r & 7)). The
// XOR puts the A reads, the row reads (B = X^T) and the accumulator-order
// reads (load_b_acc's) of a warp on 32 banks, and keeps each 16-byte piece
// of a row whole for cp.async.
__device__ __forceinline__ int swz(int r, int c) { return r * kC + (c ^ ((r & 7) << 2)); }

// cp.async of 16 (4) bytes that writes zeros where !in (src-size 0; src
// stays a valid address).
__device__ __forceinline__ void cp_async16_or_zero(void* dst, const void* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4_or_zero(void* dst, const void* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// Waits until at most n of the thread's cp.async groups are pending (n
// known only at run time; more than 6 waits for 6).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// A whole swizzled chunk tile of `rows` rows (kTile, or the fused backward's
// L rounded up to 16) by cp.async: columns [0, w) of rows [row0, row0 + n) of
// one head (base: the offset of (b, 0, h, d0)), zeros in every other row and
// column. So the products read it without bounds: zeros add nothing. 16
// bytes a copy where vec (16 threads a row), else 4 (64 threads a row; the
// block's threads a multiple of 64, or two calls of tid and tid + nthreads
// out of 2 nthreads).
__device__ __forceinline__ void load_swz_async(float* dst, const float* __restrict__ x,
                                               int64_t base, int row0, int n, int HD, int w,
                                               bool vec, int tid, int nthreads,
                                               int rows = kTile) {
  const int per_row = vec ? kC / 4 : kC, c = (tid % per_row) * (vec ? 4 : 1);
  const int r0 = tid / per_row, step = nthreads / per_row;
  const float* src = x + base + (int64_t)(row0 + r0) * HD + c;
  for (int r = r0; r < rows; r += step, src += (int64_t)step * HD) {
    const bool in = r < n && c < w;
    if (vec)
      cp_async16_or_zero(dst + swz(r, c), in ? src : x, in);
    else
      cp_async4_or_zero(dst + swz(r, c), in ? src : x, in);
  }
}

// acc[i] += X Y_i^T over one chunk of ks steps of 8 columns, X the warp's 16
// rows from r0 of a swizzled chunk tile (A fragments), Y_i its 8 rows at j0 +
// 8 i (B fragments), live pieces only. Rows r0 + g, r0 + g + 8 and j0 + 8 i
// + g all swizzle by 4 g, so one column offset a step serves every read.
template <int NT>
__device__ __forceinline__ void wide_score_products(const float* x, const float* y, int r0,
                                                    int j0, int ks, const bool (&live)[NT],
                                                    Lane l, float (&acc)[NT][4]) {
  const int sw = 4 * l.g, ra = (r0 + l.g) * kC, rb = (j0 + l.g) * kC;
#pragma unroll 2
  for (int kk = 0; kk < ks; ++kk) {
    const int c = (8 * kk + l.t) ^ sw, c4 = c ^ 4;
    const FragA a = split_a(x[ra + c], x[ra + 8 * kC + c], x[ra + c4], x[ra + 8 * kC + c4]);
#pragma unroll
    for (int i = 0; i < NT; ++i)
      if (live[i]) mma3(acc[i], a, split_b(y[rb + 8 * i * kC + c], y[rb + 8 * i * kC + c4]));
  }
}

// Columns [Dh, DP) of ntiles consecutive tiles, which the copies never
// write and B reads meet.
template <int DP>
__device__ __forceinline__ void zero_pad_columns(float* tiles, int ntiles, int Dh, int tid) {
  const int w = DP - Dh;
  for (int e = tid; e < ntiles * kTile * w; e += kLongThreads) {
    const int r = e / w;
    tiles[r * Long<DP>::kRs + Dh + (e - r * w)] = 0.f;
  }
}

// blockIdx.x = (b * tiles + tile) * H + h: the H heads of one tile of one
// batch row run side by side and share the rows' cache lines.
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

// ------------------------------------------------------------ host side
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Any Dh >= 1; the long routes' grid holds B * tiles * H blocks in x and
// the wide chunks in y.
inline bool shape_ok(int B, int L, int H, int Dh) {
  return B > 0 && L > 0 && H > 0 && Dh > 0 && chunks(Dh) <= 65535 &&
         (int64_t)L * H * Dh <= 0x7fffffff &&
         (int64_t)B * ((L + kTile - 1) / kTile) * H <= 0x7fffffff;
}

template <typename Kernel, typename... Ts>
void launch_kernel(Kernel kernel, dim3 grid, int threads, int64_t smem,
                   cudaStream_t stream, Ts... args) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  kernel<<<grid, threads, smem, stream>>>(args...);
}

// Registers, local memory (spills and stack) bytes a thread and blocks an SM
// of a kernel, as a launch of `threads` threads and `smem` bytes configures it.
template <typename Kernel>
void kernel_info(Kernel kernel, int threads, int64_t smem, int* out) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  cudaFuncAttributes attr{};
  cudaFuncGetAttributes(&attr, kernel);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, threads, (size_t)smem);
}

// Launch<DP, kTail4>::run(args...) for Dh padded to DP, a multiple of 8
// (Dh <= 64); kTail4 where Dh % 8 is 1..4 and the last 8 columns of a
// product over Dh take a k = 4 product. Launch<kC, false>::run_wide(args...)
// for any wider Dh, in chunks of kC columns.
template <template <int, bool> class Launch, typename... Ts>
void by_head_dim(int Dh, const Ts&... args) {
  if (Dh <= 4)
    Launch<8, true>::run(args...);
  else if (Dh <= 8)
    Launch<8, false>::run(args...);
  else if (Dh <= 12)
    Launch<16, true>::run(args...);
  else if (Dh <= 16)
    Launch<16, false>::run(args...);
  else if (Dh <= 24)
    Launch<24, false>::run(args...);
  else if (Dh <= 32)
    Launch<32, false>::run(args...);
  else if (Dh <= 48)
    Launch<48, false>::run(args...);
  else if (Dh <= kNarrowMaxDh)
    Launch<64, false>::run(args...);
  else
    Launch<kC, false>::run_wide(args...);
}

}  // namespace
