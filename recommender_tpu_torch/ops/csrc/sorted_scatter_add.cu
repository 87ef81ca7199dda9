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
// What bounds it: bytes, not the longest run of equal ids. At the DLRM
// shape (212,992 bf16 rows of D = 16 with `order`, into 1M x 16) it reads
// 6.8 MB of rows and 1.7 MB of ids and order entries and writes at most
// 36k f32 rows of 64 B (2.3 MB); at BST's history shape (102,400 f32 rows
// of D = 18 with `order`, into 400,000 x 18) 7.4 MB of rows, 0.8 MB of ids
// and order, at most ~4 MB of output rows. That is 3-4 us at 3.35 TB/s;
// the caller's zero fill of the table (64 MB and 29 MB) costs more. On an
// H100 80GB HBM3 (700 W) the two passes take 14.5 us at the DLRM shape, a
// quarter of the byte bound: a block's three dependent memory round trips
// (ids, `order`, rows) set the time, with one block per SM at bf16 rows
// (170 registers).
//
// Design: two passes, neither of whose blocks does work that grows with a
// run's length.
// * Pass 1, one block per chunk of `chunk` sorted positions. The block's
//   threads form `slots` row slots of `slab` lanes; a slot owns kRows
//   consecutive positions and its lanes split each row into column groups
//   of VEC elements (loads of 16, 8 or 4 bytes, or of one element; the
//   wrapper picks the widest the row allows). Each slot reads its ids and all its
//   `order` entries, then all its rows (kRows loads in flight per lane),
//   then walks them in order, summing each piece of a run in f32
//   registers. A piece that is a whole run is stored to `out` at once. A
//   piece that touches the slot's first or last position with the run
//   continuing past it goes to shared memory, beside the chunk's ids.
//   After a barrier the slot where such a run starts finds the run's last
//   slot in the chunk by a binary search of those ids (not by walking the
//   slots, which would follow the run's length) and adds the pieces of the
//   slots in between in slot order. A run that ends in the chunk is stored
//   to `out`; a run that leaves the chunk leaves one partial row per side
//   of the chunk in `partials` (scratch from the wrapper): [chunk][0] is
//   the piece that came in from the previous chunk (the whole chunk when
//   one run covers it), [chunk][1] the piece that leaves it. Rows are
//   stored with 16- or 8-byte stores where VEC allows.
// * Pass 2, one block per chunk; only the block of the chunk where a
//   crossing run starts does work. It counts the chunks the run covers
//   (their first id equals the run's id; one barrier-count per 256 chunks)
//   and sums the run's partial rows in chunk order: its lanes take
//   contiguous stretches of them, and the stretch sums are added in
//   stretch order. Then it stores the row.
// Every touched row is stored once, by exactly one thread, as a sum in a
// fixed order that depends only on the ids and the launch geometry, so
// there are no atomics and two launches are bitwise equal. Rows no id
// touches stay as the caller's zero fill. No pass reads anything back to
// the host.
//
// Accumulation is always exact f32. The TPU kernel's `precision` argument
// chose between bf16-rounded operand passes (TPU DEFAULT) and exact f32
// (HIGHEST); here f32 accumulation is exact f32 at no extra cost, so the
// wrapper accepts `precision` for signature parity only. ROUND_BF16
// reproduces `kernel_dtype=bf16`: each f32 contribution is rounded to bf16
// before it is added in f32.
//
// C interface for ctypes: pointers and the stream as void*; the geometry
// (slab, slots, chunk) comes from the wrapper, which also sizes `partials`
// from it; the return value is the first cudaGetLastError() after a launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // positions per row slot

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

// VEC f32 at dst or src, which are aligned to VEC * 4 bytes: the rows of
// `out` and `partials` hold d (a multiple of VEC) floats, a lane's columns
// start at a multiple of VEC, and the shared arrays are 16-byte aligned.
template <int VEC>
__device__ __forceinline__ void store(float* dst, const float (&acc)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      *reinterpret_cast<float4*>(dst + k) =
          make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
  } else {
    dst[0] = acc[0];
  }
}

template <int VEC>
__device__ __forceinline__ void add(float (&acc)[VEC], const float* src) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + k);
      acc[k] += v.x, acc[k + 1] += v.y, acc[k + 2] += v.z, acc[k + 3] += v.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    acc[0] += v.x, acc[1] += v.y;
  } else {
    acc[0] += src[0];
  }
}

// First position in [lo, hi) whose id exceeds v; a[] is ascending.
__device__ __forceinline__ int upper_bound(const int32_t* a, int lo, int hi,
                                           int32_t v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Pass 1: the pieces of runs inside one chunk of sorted positions.
template <typename T, int VEC, bool ROUND_BF16>
__global__ void __launch_bounds__(kThreads)
    chunk_sum_kernel(const int32_t* __restrict__ ids, const T* __restrict__ upd,
                     const int32_t* __restrict__ order, float* __restrict__ out,
                     float* __restrict__ partials, int64_t n, int d,
                     int64_t vocab, int slab, int slots) {
  __shared__ __align__(16) float lead[kThreads * VEC];   // per lane: its slot's lead piece
  __shared__ __align__(16) float trail[kThreads * VEC];  // per lane: its slot's trail piece
  __shared__ bool covered[kThreads];  // per slot: one run covers it and goes on
  __shared__ int32_t chunk_ids[kThreads * kRows];

  const int t = threadIdx.x;
  const int s = t / slab;  // row slot
  const int g = t % slab;  // column group inside the slab
  const int64_t chunk_id = blockIdx.x;
  const int64_t c0 = chunk_id * slots * kRows;
  const int chunk_len = n - c0 < slots * kRows ? (int)(n - c0) : slots * kRows;
  const int64_t p0 = c0 + (int64_t)s * kRows;
  const int cnt = s >= slots || p0 >= n ? 0 : n - p0 < kRows ? (int)(n - p0) : kRows;
  const bool has_prev = cnt > 0 && p0 > 0;
  const bool has_next = cnt > 0 && p0 + cnt < n;
  const int32_t prev = has_prev ? ids[p0 - 1] : 0;
  const int32_t next = has_next ? ids[p0 + cnt] : 0;

  int32_t id[kRows];
  int64_t src[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) id[j] = j < cnt ? ids[p0 + j] : 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {  // all order entries before any row
    const bool valid = j < cnt && id[j] >= 0 && id[j] < vocab;
    src[j] = !valid ? -1 : order != nullptr ? (int64_t)order[p0 + j] : p0 + j;
  }
  const int32_t first = id[0];
  int32_t last = id[0];
#pragma unroll
  for (int j = 1; j < kRows; ++j)
    if (j < cnt) last = id[j];
  // lead: the first piece continues a run from before the slot; through:
  // that run also covers the slot and goes on past it; trail: the last
  // piece starts in the slot and its run goes on past it.
  const bool lead_run =
      has_prev && prev == first && first >= 0 && first < vocab;
  const bool through = lead_run && last == first && has_next && next == first;
  const bool trail_run =
      !through && has_next && next == last && last >= 0 && last < vocab;
  if (g == 0 && s < slots) {
    covered[s] = through;
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (j < cnt) chunk_ids[s * kRows + j] = id[j];
  }

  const int groups = d / VEC;
  for (int g0 = 0; g0 < groups; g0 += slab) {
    const bool lane_live = cnt > 0 && g0 + g < groups;
    const int64_t col = (int64_t)(g0 + g) * VEC;

    Pack<T, VEC> row[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (lane_live && src[j] >= 0)
        row[j] = *reinterpret_cast<const Pack<T, VEC>*>(upd + src[j] * d + col);
    }

    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    int start = 0;  // first position of the current piece
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < cnt) {
        if (lane_live && src[j] >= 0) {
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            acc[k] += contribution<T, ROUND_BF16>(row[j].v[k]);
        }
        const bool ends = j == cnt - 1 || (j + 1 < kRows && id[j + 1] != id[j]);
        if (ends) {
          if (lane_live && src[j] >= 0) {
            const bool before = start == 0 && lead_run;
            const bool after = j == cnt - 1 && has_next && next == id[j];
            if (before)  // lead, or the whole slot (through)
              store<VEC>(lead + t * VEC, acc);
            else if (after)
              store<VEC>(trail + t * VEC, acc);
            else
              store<VEC>(out + (int64_t)id[j] * d + col, acc);
          }
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
          start = j + 1;
        }
      }
    }
    __syncthreads();

    if (lane_live) {
      // Adds the lead pieces of slots from..q_stop in slot order, where
      // q_stop holds the last position of run `run_id` in this chunk (found
      // by a binary search of the chunk's ids); returns q_stop.
      auto gather = [&](int from, int32_t run_id, float(&sum)[VEC]) {
        const int q_stop =
            (upper_bound(chunk_ids, from * kRows, chunk_len, run_id) - 1) / kRows;
        for (int q = from; q <= q_stop; ++q)
          add<VEC>(sum, lead + (q * slab + g) * VEC);
        return q_stop;
      };
      float sum[VEC];
      if (s == 0 && lead_run) {  // the run that came in from the last chunk
#pragma unroll
        for (int k = 0; k < VEC; ++k) sum[k] = 0.f;
        gather(0, first, sum);
        store<VEC>(partials + chunk_id * 2 * d + col, sum);
      }
      if (trail_run) {  // a run that starts in this slot and leaves it
#pragma unroll
        for (int k = 0; k < VEC; ++k) sum[k] = 0.f;
        add<VEC>(sum, trail + t * VEC);
        // it leaves the chunk too where its last slot here is this one (the
        // chunk's last) or one it covers
        const int q_stop = gather(s + 1, last, sum);
        float* dst = q_stop == s || covered[q_stop]
                         ? partials + (chunk_id * 2 + 1) * d + col
                         : out + (int64_t)last * d + col;
        store<VEC>(dst, sum);
      }
    }
    __syncthreads();  // the next slab reuses lead and trail
  }
}

// Pass 2: the runs that cross chunk boundaries, each summed by the block of
// the chunk where it starts.
__global__ void __launch_bounds__(kThreads)
    join_kernel(const int32_t* __restrict__ ids,
                const float* __restrict__ partials, float* __restrict__ out,
                int64_t n, int d, int64_t vocab, int64_t chunk,
                int64_t num_chunks) {
  __shared__ float stretch[kThreads];
  const int64_t k = blockIdx.x;
  const int64_t end = (k + 1) * chunk;  // first position of the next chunk
  if (end >= n) return;
  const int32_t id = ids[end];
  if (ids[end - 1] != id || id < 0 || id >= vocab) return;  // nothing leaves
  if (k > 0 && ids[k * chunk - 1] == id) return;  // the run started earlier

  // chunks k+1, k+2, ... that the run covers: their first id is the run's
  int64_t covered = 0;
  for (int64_t base = k + 1; base < num_chunks; base += kThreads) {
    const int64_t j = base + threadIdx.x;
    const int c = __syncthreads_count(j < num_chunks && ids[j * chunk] == id);
    covered += c;
    if (c < kThreads) break;
  }
  // the run's pieces: [k][1], then [k+1][0] ... [k+covered][0]
  const int64_t pieces = covered + 1;
  const int width = min(d, kThreads);
  const int stretches = kThreads / width;
  const int r = threadIdx.x / width;
  for (int c0 = 0; c0 < d; c0 += width) {
    const int c = c0 + threadIdx.x % width;
    const bool live = r < stretches && c < d;
    float acc = 0.f;
    if (live) {
      const int64_t q0 = pieces * r / stretches;
      const int64_t q1 = pieces * (r + 1) / stretches;
#pragma unroll 4
      for (int64_t q = q0; q < q1; ++q)
        acc += partials[(q == 0 ? 2 * k + 1 : 2 * (k + q)) * d + c];
    }
    stretch[threadIdx.x] = acc;
    __syncthreads();
    if (live && r == 0) {
      float sum = 0.f;
      for (int i = 0; i < stretches; ++i) sum += stretch[i * width + threadIdx.x];
      out[(int64_t)id * d + c] = sum;
    }
    __syncthreads();
  }
}

template <typename T, int VEC, bool ROUND_BF16>
int launch(const void* ids, const void* upd, const void* order, void* out,
           void* partials, int64_t n, int d, int64_t vocab, int slab,
           int slots, cudaStream_t stream) {
  const int64_t chunk = (int64_t)slots * kRows;
  const int64_t num_chunks = (n + chunk - 1) / chunk;
  const int32_t* ids_p = static_cast<const int32_t*>(ids);
  float* out_p = static_cast<float*>(out);
  float* part_p = static_cast<float*>(partials);
  chunk_sum_kernel<T, VEC, ROUND_BF16>
      <<<(unsigned)num_chunks, kThreads, 0, stream>>>(
          ids_p, static_cast<const T*>(upd), static_cast<const int32_t*>(order),
          out_p, part_p, n, d, vocab, slab, slots);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  join_kernel<<<(unsigned)num_chunks, kThreads, 0, stream>>>(
      ids_p, part_p, out_p, n, d, vocab, chunk, num_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// upd_bf16: 0 = f32 updates, 1 = bf16 updates.
// round_bf16: round each f32 contribution to bf16 (kernel_dtype=bf16).
// vec: elements per column group (a 16-, 8-, 4- or 2-byte load); the caller
//      guarantees d % vec == 0 and rows aligned to vec elements.
// slab: column groups per slab (lanes per row slot); slots: row slots per
//      block, slab * slots <= 256; chunk: positions per block, which must be
//      slots * kRows (the caller sized `partials` by it).
// partials: 2 * d f32 per chunk, uninitialised.
extern "C" int rtt_sorted_scatter_add(const void* ids, const void* upd,
                                      const void* order, void* out,
                                      void* partials, long long n, int d,
                                      long long vocab, int upd_bf16,
                                      int round_bf16, int vec, int slab,
                                      int slots, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d <= 0 || vec <= 0 || d % vec || slab <= 0 || slots <= 0 ||
      slab * slots > kThreads || chunk != slots * kRows)
    return (int)cudaErrorInvalidValue;
#define RTT_LAUNCH(T, V, R) \
  launch<T, V, R>(ids, upd, order, out, partials, n, d, vocab, slab, slots, st)
  if (upd_bf16) {
    switch (vec) {
      case 8: return RTT_LAUNCH(__nv_bfloat16, 8, false);
      case 4: return RTT_LAUNCH(__nv_bfloat16, 4, false);
      case 2: return RTT_LAUNCH(__nv_bfloat16, 2, false);
      case 1: return RTT_LAUNCH(__nv_bfloat16, 1, false);
    }
  } else if (round_bf16) {
    switch (vec) {
      case 4: return RTT_LAUNCH(float, 4, true);
      case 2: return RTT_LAUNCH(float, 2, true);
      case 1: return RTT_LAUNCH(float, 1, true);
    }
  } else {
    switch (vec) {
      case 4: return RTT_LAUNCH(float, 4, false);
      case 2: return RTT_LAUNCH(float, 2, false);
      case 1: return RTT_LAUNCH(float, 1, false);
    }
  }
#undef RTT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
