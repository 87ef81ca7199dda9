// Sorted scatter-add (segment sum) of embedding-gradient rows into a table.
//
// Replaces the TPU kernel recommender_tpu/ops/embedding_kernels.py::
// sorted_scatter_add -> _packed_scatter_kernel (the Pallas packed
// scatter-as-matmul). It computes the same function,
//
//     out[v, :] = sum over i with ids[i] == v of upd[order[i], :]
//
// over ascending `ids`, dropping ids outside [0, vocab). It is not carried
// over block by block: the TPU kernel's one-hot matmul and 128-lane packing
// exist for the MXU and the TPU's vector layout, and have no use here.
//
// What bounds it on the card: memory bytes. At the DLRM shape (212,992
// f32 rows of D = 16 into a 1M x 16 table) it reads about 213k x 64 B of
// updates plus their ids, and the caller zero-fills and this kernel writes
// parts of a 1M x 64 B table; there is no arithmetic to speak of.
//
// Design:
// * One warp per tile of 32 sorted positions. A lane marks its position as
//   the head of a run (first position of a new id); the warp walks the
//   heads of its tile in order and sums each whole run, even where the run
//   extends past the tile. Every touched row is summed by exactly one warp
//   and stored once, so no atomics are needed and the result is bitwise
//   deterministic. Rows no id touches stay as the caller's zero fill.
// * Inside a run, lanes split the row as column groups of VEC elements
//   (one 16-byte load each where the row allows it) and stride over the
//   rows; each lane keeps f32 sums in registers. kUnroll chunks are loaded
//   before they are added, to keep several loads in flight. Because ids
//   are sorted, a row belongs to the run iff its id equals the run's id,
//   so the run's end needs no separate search.
// * The lanes' partial sums are combined through shared memory in a fixed
//   row order, then written with plain stores.
// * `order` (may be null) is read as an indirect row gather: row i of the
//   run reads upd[order[i]], so the caller never materializes a permuted
//   copy of the gradient.
// * Accumulation is always exact f32. The TPU kernel's `precision` argument
//   chose between bf16-rounded operand passes (TPU DEFAULT) and exact f32
//   (HIGHEST); here f32 accumulation is exact f32 at no extra cost, so the
//   wrapper accepts `precision` for signature parity only. ROUND_BF16
//   reproduces `kernel_dtype=bf16`: each f32 contribution is rounded to
//   bf16 before it is added in f32.
//
// Known limit: a warp's time is set by its longest run. On Zipf-skewed CTR
// ids one id can hold a sixth of the batch, and that single run sets the
// kernel's time.
//
// C interface for ctypes: pointers and the stream as void*, and the return
// value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, bool ROUND_BF16>
__device__ __forceinline__ float contribution(T v);

template <>
__device__ __forceinline__ float contribution<float, false>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float contribution<float, true>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <>
__device__ __forceinline__ float contribution<__nv_bfloat16, false>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int VEC, bool ROUND_BF16>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    sorted_segment_sum_kernel(const int32_t* __restrict__ ids,
                              const T* __restrict__ upd,
                              const int32_t* __restrict__ order,
                              float* __restrict__ out, int64_t n, int d,
                              int64_t vocab) {
  __shared__ float partial[kWarpsPerBlock][kWarp][VEC];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t tile_start =
      ((int64_t)blockIdx.x * kWarpsPerBlock + warp) * kWarp;
  if (tile_start >= n) return;  // uniform across the warp

  const int64_t p = tile_start + lane;
  bool head = false;
  if (p < n) {
    const int32_t id = ids[p];
    head = (p == 0 || ids[p - 1] != id) && id >= 0 && id < vocab;
  }
  unsigned heads = __ballot_sync(0xffffffffu, head);
  const int groups = d / VEC;  // column groups of VEC elements per row

  while (heads) {
    const int h = __ffs((int)heads) - 1;
    heads &= heads - 1;
    const int64_t start = tile_start + h;
    const int32_t id = ids[start];

    for (int g0 = 0; g0 < groups; g0 += kWarp) {
      const int gs = min(groups - g0, kWarp);  // column groups in this slab
      const int rows = kWarp / gs;             // rows per chunk
      const bool active = lane < rows * gs;
      const int row_in_chunk = lane / gs;
      const int g = g0 + lane % gs;

      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

      for (int64_t base = start;; base += (int64_t)kUnroll * rows) {
        int64_t src[kUnroll];
        bool live[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t r = base + (int64_t)u * rows + row_in_chunk;
          live[u] = active && r < n && ids[r] == id;
          src[u] = live[u] ? (order != nullptr ? (int64_t)order[r] : r) : 0;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (live[u]) {
            const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(
                upd + src[u] * d + (int64_t)g * VEC);
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              acc[k] += contribution<T, ROUND_BF16>(pk.v[k]);
          }
        }
        const int64_t next = base + (int64_t)kUnroll * rows;
        if (next >= n || ids[next] != id) break;
      }

#pragma unroll
      for (int k = 0; k < VEC; ++k) partial[warp][lane][k] = acc[k];
      __syncwarp();
      if (lane < gs) {
        float s[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) s[k] = 0.f;
        for (int r = 0; r < rows; ++r) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) s[k] += partial[warp][r * gs + lane][k];
        }
        float* dst = out + (int64_t)id * d + (int64_t)(g0 + lane) * VEC;
#pragma unroll
        for (int k = 0; k < VEC; ++k) dst[k] = s[k];
      }
      __syncwarp();
    }
  }
}

template <typename T, int VEC, bool ROUND_BF16>
void launch(const void* ids, const void* upd, const void* order, void* out,
            int64_t n, int d, int64_t vocab, cudaStream_t stream) {
  const int64_t tiles = (n + kWarp - 1) / kWarp;
  const int64_t blocks = (tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sorted_segment_sum_kernel<T, VEC, ROUND_BF16>
      <<<(unsigned)blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
          static_cast<const int32_t*>(ids), static_cast<const T*>(upd),
          static_cast<const int32_t*>(order), static_cast<float*>(out), n, d,
          vocab);
}

}  // namespace

// upd_bf16: 0 = f32 updates, 1 = bf16 updates.
// round_bf16: round each f32 contribution to bf16 (kernel_dtype=bf16).
// vec: elements per column group, 1 or 16 bytes' worth (4 f32 / 8 bf16);
//      the caller guarantees d % vec == 0 and 16-byte aligned rows.
extern "C" int rtt_sorted_scatter_add(const void* ids, const void* upd,
                                      const void* order, void* out,
                                      long long n, int d, long long vocab,
                                      int upd_bf16, int round_bf16, int vec,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (upd_bf16) {
    if (vec == 8)
      launch<__nv_bfloat16, 8, false>(ids, upd, order, out, n, d, vocab, s);
    else if (vec == 1)
      launch<__nv_bfloat16, 1, false>(ids, upd, order, out, n, d, vocab, s);
    else
      return (int)cudaErrorInvalidValue;
  } else if (round_bf16) {
    if (vec == 4)
      launch<float, 4, true>(ids, upd, order, out, n, d, vocab, s);
    else if (vec == 1)
      launch<float, 1, true>(ids, upd, order, out, n, d, vocab, s);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    if (vec == 4)
      launch<float, 4, false>(ids, upd, order, out, n, d, vocab, s);
    else if (vec == 1)
      launch<float, 1, false>(ids, upd, order, out, n, d, vocab, s);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
