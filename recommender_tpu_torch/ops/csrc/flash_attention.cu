// Flash attention forward with a segment-id mask, for small head dims (Dh <= 64).
//
// Replaces the TPU kernel that recommender_tpu/nn/transformer.py::_flash_mha
// reaches through jax.experimental.pallas.ops.tpu.flash_attention:
// _flash_attention_impl (jax 0.9.0, flash_attention.py:589), the forward,
// which saves the row log-sum-exp for the backward. The backward is
// flash_attention_bwd.cu. It computes the same function on every row the TPU
// kernel defines,
//
//     o[b, i, h, :] = sum_j softmax_j(scale * q[b,i,h,:] . k[b,j,h,:]) v[b,j,h,:]
//
// over the keys j with seg[b, j] == seg[b, i] (SegmentIds(seg, seg)). Every
// row sees itself, so no row is fully masked. Unlike the TPU wrapper it pads
// neither L to a 128-row block nor Dh to 128 lanes: the ragged edges are
// masked here, so `scale` is 1/sqrt(real Dh) and no inert padding position
// takes part.
//
// Layout: q, k, v, o are f32 [B, L, H, Dh] (heads-last, contiguous); seg is
// int32 [B, L]; lse is f32 [B, H, L].
//
// What bounds it on the card: at BST's shape (B 1024, L 101, H 4, Dh 9)
// q, k, v and o are about 60 MB together and the forward is only ~0.75
// GFLOP, so neither bytes nor FLOPs set its time: the per-thread FMA loop
// over shared-memory rows and its latency do. Measured on an H100 80GB HBM3
// (700 W limit): 0.25 ms, i.e. ~240 GB/s of the 3.35 TB/s.
//
// Design:
// * One block per (batch, query tile of 64 rows, head); one row per thread
//   (two threads per row for Dh > 32, each holding half of the row and
//   combining dot products with one shuffle). The thread keeps its own row's
//   vectors and accumulators in registers; the key rows stream through
//   shared memory in tiles of 64, read by every thread of the block at the
//   same address (broadcast, no bank conflicts).
// * Dh is padded in registers and shared memory to the next supported
//   width DPAD (8, 12, 16, 24, 32, 48, 64) with zeros, so the dot products
//   are exact and unrolled; loads and stores are guarded by the real Dh.
// * Tiles are loaded and results stored through shared memory, so that
//   consecutive threads touch consecutive addresses of a row.
// * Online softmax in base 2 (q is pre-scaled by scale * log2 e); the
//   running max is rescaled only when a key raises it. It stores the
//   natural-log log-sum-exp per row for the backward.
//
// C interface for ctypes: pointers and the stream as void*; the entry
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;  // rows per block and rows per shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// DT dims per thread, TPR threads per row: DPAD = DT * TPR. Each thread's
// chunk of a shared row is CS floats apart, one more than DT when TPR > 1,
// so the two chunks of a row sit in different banks.
template <int DT, int TPR>
struct Cfg {
  static constexpr int kDpad = DT * TPR;
  static constexpr int kCs = TPR > 1 ? DT + 1 : DT;
  static constexpr int kRs = kCs * TPR;
  static constexpr int kThreads = kRows * TPR;
};

// Rows [row0, row0 + kRows) of one (b, h) slice of a [B, L, H, Dh] tensor
// into dst[kRows][kRs]; zeros past L and past Dh.
template <int DT, int TPR>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ x,
                                          int64_t base, int row0, int L,
                                          int64_t rstride, int Dh, int tid) {
  using C = Cfg<DT, TPR>;
  for (int e = tid; e < kRows * C::kDpad; e += C::kThreads) {
    const int r = e / C::kDpad, d = e - r * C::kDpad;
    const int row = row0 + r;
    float val = 0.f;
    if (row < L && d < Dh) val = x[base + (int64_t)row * rstride + d];
    dst[r * C::kRs + (d / DT) * C::kCs + d % DT] = val;
  }
}

template <int DT, int TPR>
__device__ __forceinline__ void store_tile(float* __restrict__ x, const float* src,
                                           int64_t base, int row0, int L,
                                           int64_t rstride, int Dh, int tid) {
  using C = Cfg<DT, TPR>;
  for (int e = tid; e < kRows * C::kDpad; e += C::kThreads) {
    const int r = e / C::kDpad, d = e - r * C::kDpad;
    const int row = row0 + r;
    if (row < L && d < Dh)
      x[base + (int64_t)row * rstride + d] = src[r * C::kRs + (d / DT) * C::kCs + d % DT];
  }
}

// Per-row vectors of a [B, H, L] tensor (or seg [B, L]) into shared memory.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ x,
                                          int64_t base, int row0, int L,
                                          T fill, T mul, int tid) {
  if (tid < kRows) dst[tid] = row0 + tid < L ? x[base + row0 + tid] * mul : fill;
}

// Dot product of this thread's DT registers with its chunk of a shared row;
// the TPR threads of a row add their halves. Every lane of the warp calls
// it (the loops around it are uniform across the block).
template <int DT, int TPR>
__device__ __forceinline__ float dot(const float (&a)[DT], const float* row) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DT; ++d) s = fmaf(a[d], row[d], s);
  if (TPR > 1) s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s;
}

template <int DT, int TPR>
__device__ __forceinline__ void row_to_regs(float (&dst)[DT], const float* tile,
                                            int r, int c, float mul) {
  using C = Cfg<DT, TPR>;
#pragma unroll
  for (int d = 0; d < DT; ++d) dst[d] = tile[r * C::kRs + c * C::kCs + d] * mul;
}

template <int DT, int TPR>
__device__ __forceinline__ void regs_to_row(float* tile, const float (&src)[DT],
                                            int r, int c, float mul) {
  using C = Cfg<DT, TPR>;
#pragma unroll
  for (int d = 0; d < DT; ++d) tile[r * C::kRs + c * C::kCs + d] = src[d] * mul;
}

// blockIdx.x = (b * tiles + tile) * H + h: the H heads of one tile of one
// batch row run side by side and share the rows' cache lines.
struct Where {
  int b, h, row0;
  int64_t base;  // offset of (b, 0, h, 0) in a [B, L, H, Dh] tensor
};

__device__ __forceinline__ Where where(int L, int H, int Dh) {
  const int tiles = (L + kRows - 1) / kRows;
  int blk = blockIdx.x;
  Where w;
  w.h = blk % H;
  blk /= H;
  w.row0 = (blk % tiles) * kRows;
  w.b = blk / tiles;
  w.base = (int64_t)w.b * L * H * Dh + (int64_t)w.h * Dh;
  return w;
}

template <int DT, int TPR>
__global__ void __launch_bounds__(Cfg<DT, TPR>::kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg,
                 float* __restrict__ o, float* __restrict__ lse, int L, int H,
                 int Dh, float scale) {
  using C = Cfg<DT, TPR>;
  __shared__ float ks[kRows * C::kRs];
  __shared__ float vs[kRows * C::kRs];
  __shared__ int segs[kRows];
  const int tid = threadIdx.x, r = tid / TPR, c = tid % TPR;
  const Where w = where(L, H, Dh);
  const int64_t rstride = (int64_t)H * Dh;
  const int i = w.row0 + r;

  load_tile<DT, TPR>(ks, q, w.base, w.row0, L, rstride, Dh, tid);
  __syncthreads();
  float qr[DT];
  row_to_regs<DT, TPR>(qr, ks, r, c, scale * kLog2e);  // scores in base 2
  const int qseg = i < L ? seg[(int64_t)w.b * L + i] : 0;
  __syncthreads();

  float m = -INFINITY, l = 0.f, acc[DT];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d] = 0.f;
  for (int k0 = 0; k0 < L; k0 += kRows) {
    load_tile<DT, TPR>(ks, k, w.base, k0, L, rstride, Dh, tid);
    load_tile<DT, TPR>(vs, v, w.base, k0, L, rstride, Dh, tid);
    load_rows<int>(segs, seg, (int64_t)w.b * L, k0, L, 0, 1, tid);
    __syncthreads();
    const int n = min(kRows, L - k0);
    for (int j = 0; j < n; ++j) {
      const float s = dot<DT, TPR>(qr, ks + j * C::kRs + c * C::kCs);
      if (segs[j] == qseg) {
        if (s > m) {  // a new row max: rescale what was summed so far
          const float corr = exp2f(m - s);
          l *= corr;
#pragma unroll
          for (int d = 0; d < DT; ++d) acc[d] *= corr;
          m = s;
        }
        const float p = exp2f(s - m);
        l += p;
        const float* vr = vs + j * C::kRs + c * C::kCs;
#pragma unroll
        for (int d = 0; d < DT; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
      }
    }
    __syncthreads();
  }
  // rows past L have nothing to store; their l may be 0
  regs_to_row<DT, TPR>(ks, acc, r, c, i < L ? 1.f / l : 0.f);
  __syncthreads();
  store_tile<DT, TPR>(o, ks, w.base, w.row0, L, rstride, Dh, tid);
  if (c == 0 && i < L)
    lse[((int64_t)w.b * H + w.h) * L + i] = (m + log2f(l)) * kLn2;
}

struct Args {
  const float *q, *k, *v;
  const int* seg;
  float *o, *lse;
  int B, L, H, Dh;
  float scale;
};

template <int DT, int TPR>
void launch(const Args& a, cudaStream_t stream) {
  const int tiles = (a.L + kRows - 1) / kRows;
  const dim3 grid((unsigned)((int64_t)a.B * tiles * a.H));
  flash_fwd_kernel<DT, TPR><<<grid, Cfg<DT, TPR>::kThreads, 0, stream>>>(
      a.q, a.k, a.v, a.seg, a.o, a.lse, a.L, a.H, a.Dh, a.scale);
}

int dispatch(const Args& a, void* stream) {
  if (a.B <= 0 || a.L <= 0 || a.H <= 0 || a.Dh <= 0 || a.Dh > 64 ||
      (int64_t)a.B * ((a.L + kRows - 1) / kRows) * a.H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.Dh <= 8)
    launch<8, 1>(a, s);
  else if (a.Dh <= 12)
    launch<12, 1>(a, s);
  else if (a.Dh <= 16)
    launch<16, 1>(a, s);
  else if (a.Dh <= 24)
    launch<24, 1>(a, s);
  else if (a.Dh <= 32)
    launch<32, 1>(a, s);
  else if (a.Dh <= 48)
    launch<24, 2>(a, s);
  else
    launch<32, 2>(a, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Forward: o [B, L, H, Dh] and lse [B, H, L] (natural log).
extern "C" int rtt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* seg, void* o, void* lse,
                                       int B, int L, int H, int Dh, float scale,
                                       void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.seg = static_cast<const int*>(seg);
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.B = B; a.L = L; a.H = H; a.Dh = Dh; a.scale = scale;
  return dispatch(a, stream);
}

