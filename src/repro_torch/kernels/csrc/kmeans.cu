// k-means assignment and fused assign+update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/kmeans.py: the body
// _make_kernel (:80) behind pl.pallas_call (:196), reached through
// kmeans_assign_update (:222, fused) and kmeans_assign (:213, assign only).
//
// What it computes, per point row x against K centroids c (F features):
//   d2[k] = max(|x|^2 - 2 x.c_k + |c_k|^2, 0)     (the expansion, not sum (x-c)^2,
//                                                  so ids and the dmin floor near
//                                                  d = 0 round like the reference)
//   id    = first k with the smallest d2           (strict <, as jnp.argmin)
//   dmin  = sqrt(d2[id])
// and, in the fused form, the per-centroid sums (K,F) and counts (K) of the
// rows assigned to each centroid.
//
// What bounds it on an H100: it reads the points once, N*F*{4,2,1} bytes for
// fp32/bf16/int8, and writes 8N bytes of ids and distances; it does 2*N*K*F
// flops of dot products.  At the paper's K=25, F=32 that is 12.5 flops per
// fp32 byte, far below the card's ridge, so it is bound by device memory for
// fp32 and bf16, and by fp32 FMA issue for int8 (the per-feature scales do not
// factor out of an int8 product, so the products run dequantized in fp32).
//
// What this design does about it: every point byte is read from device memory
// exactly once, with coalesced loads, into a shared-memory tile of 256 rows
// (dequantized to fp32 as it lands); the centroids and |c|^2 are staged once
// per block in shared memory and read as warp broadcasts.  One thread owns one
// row, so the argmin needs no communication.  The fused form reuses the same
// tile for the membership sums: each block writes its partial (K,F) sums and
// (K) counts, accumulated over its rows in a fixed order, and a second small
// kernel adds the partials over blocks in a fixed order.  No atomics: the
// fused outputs are bit-identical from launch to launch.  The distance loop
// issues two shared loads per FMA, so the kernel is bound by shared-memory
// issue rather than by device memory; register tiling and wgmma are later work.
//
// C interface for ctypes: every pointer and the stream are void*, and each
// entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block; one point row per thread
constexpr int kRows = kThreads;

enum PointType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float v, float) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v, float) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);  // bf16 bits, exact
}
__device__ __forceinline__ float to_f32(int8_t v, float scale) {
  return static_cast<float>(v) * scale;  // the reference's dequantize
}

// Row stride of the shared tile: odd, so the 32 rows a warp reads at one
// feature fall in 32 different banks.
__host__ __device__ __forceinline__ int tile_stride(int f) { return f | 1; }

size_t smem_bytes(int f, int k) {
  return sizeof(float) * (static_cast<size_t>(k) * f + k + f +
                          static_cast<size_t>(kRows) * tile_stride(f)) +
         sizeof(int) * kRows;
}

template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads)
    assign_kernel(const T* __restrict__ pts, const float* __restrict__ cent,
                  const float* __restrict__ c2, const float* __restrict__ scales,
                  int n, int f, int k, int32_t* __restrict__ ids,
                  float* __restrict__ dmin, float* __restrict__ psums,
                  float* __restrict__ pcounts) {
  extern __shared__ float smem[];
  const int stride = tile_stride(f);
  float* s_cent = smem;               // (k, f)
  float* s_c2 = s_cent + k * f;       // (k)
  float* s_scale = s_c2 + k;          // (f)
  float* s_x = s_scale + f;           // (kRows, stride)
  int* s_ids = reinterpret_cast<int*>(s_x + kRows * stride);  // (kRows)

  const int tid = threadIdx.x;
  const long row0 = static_cast<long>(blockIdx.x) * kRows;
  const long left = n - row0;  // rows from this tile's first to the end
  const int rows = left < kRows ? static_cast<int>(left) : kRows;

  for (int i = tid; i < k * f; i += kThreads) s_cent[i] = cent[i];
  for (int i = tid; i < k; i += kThreads) s_c2[i] = c2[i];
  for (int i = tid; i < f; i += kThreads) s_scale[i] = scales ? scales[i] : 1.0f;
  __syncthreads();

  // the block's rows are contiguous: neighbouring threads load neighbouring
  // elements, and each element lands dequantized in its (row, feature) slot
  const T* tile = pts + row0 * f;
  for (int i = tid; i < rows * f; i += kThreads) {
    const int r = i / f;
    const int j = i - r * f;
    s_x[r * stride + j] = to_f32(tile[i], s_scale[j]);
  }
  __syncthreads();

  if (tid < rows) {
    const float* x = s_x + tid * stride;
    float x2 = 0.0f;
    for (int j = 0; j < f; ++j) x2 = fmaf(x[j], x[j], x2);
    float best = INFINITY;
    int best_id = 0;
    for (int c = 0; c < k; ++c) {
      const float* cc = s_cent + c * f;
      float dot = 0.0f;
      for (int j = 0; j < f; ++j) dot = fmaf(x[j], cc[j], dot);
      const float d2 = fmaxf(x2 - 2.0f * dot + s_c2[c], 0.0f);
      if (d2 < best) {
        best = d2;
        best_id = c;
      }
    }
    ids[row0 + tid] = best_id;
    dmin[row0 + tid] = sqrtf(best);
    if (kFused) s_ids[tid] = best_id;
  }
  if (!kFused) return;
  __syncthreads();

  // this block's partial sums: one thread per (centroid, feature) element,
  // walking the valid rows in order; rows >= n never reach the partials
  float* bsums = psums + static_cast<long>(blockIdx.x) * k * f;
  for (int e = tid; e < k * f; e += kThreads) {
    const int c = e / f;
    const int j = e - c * f;
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r)
      if (s_ids[r] == c) acc += s_x[r * stride + j];
    bsums[e] = acc;
  }
  float* bcounts = pcounts + static_cast<long>(blockIdx.x) * k;
  for (int c = tid; c < k; c += kThreads) {
    float cnt = 0.0f;
    for (int r = 0; r < rows; ++r) cnt += (s_ids[r] == c) ? 1.0f : 0.0f;
    bcounts[c] = cnt;
  }
}

// Adds the per-block partials over blocks 0..nblocks-1 in order: one thread
// per output element, the K*F sums first, then the K counts.
__global__ void __launch_bounds__(kThreads)
    reduce_partials(const float* __restrict__ psums,
                    const float* __restrict__ pcounts, int nblocks, int kf,
                    int k, float* __restrict__ sums, float* __restrict__ counts) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e < kf) {
    float acc = 0.0f;
    for (int b = 0; b < nblocks; ++b) acc += psums[static_cast<long>(b) * kf + e];
    sums[e] = acc;
  } else if (e < kf + k) {
    const int c = e - kf;
    float acc = 0.0f;
    for (int b = 0; b < nblocks; ++b) acc += pcounts[static_cast<long>(b) * k + c];
    counts[c] = acc;
  }
}

template <typename T, bool kFused>
cudaError_t launch_assign(const void* pts, const void* cent, const void* c2,
                          const void* scales, int n, int f, int k, void* ids,
                          void* dmin, void* psums, void* pcounts,
                          cudaStream_t stream) {
  const size_t smem = smem_bytes(f, k);
  cudaError_t err = cudaFuncSetAttribute(
      assign_kernel<T, kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nblocks = (n + kRows - 1) / kRows;
  assign_kernel<T, kFused><<<nblocks, kThreads, smem, stream>>>(
      static_cast<const T*>(pts), static_cast<const float*>(cent),
      static_cast<const float*>(c2), static_cast<const float*>(scales), n, f, k,
      static_cast<int32_t*>(ids), static_cast<float*>(dmin),
      static_cast<float*>(psums), static_cast<float*>(pcounts));
  return cudaGetLastError();
}

template <bool kFused>
cudaError_t dispatch(int dtype, const void* pts, const void* cent,
                     const void* c2, const void* scales, int n, int f, int k,
                     void* ids, void* dmin, void* psums, void* pcounts,
                     cudaStream_t stream) {
  switch (dtype) {
    case kF32:
      return launch_assign<float, kFused>(pts, cent, c2, scales, n, f, k, ids,
                                          dmin, psums, pcounts, stream);
    case kBF16:
      return launch_assign<uint16_t, kFused>(pts, cent, c2, scales, n, f, k,
                                             ids, dmin, psums, pcounts, stream);
    case kI8:
      return launch_assign<int8_t, kFused>(pts, cent, c2, scales, n, f, k, ids,
                                           dmin, psums, pcounts, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of either kernel form needs.
size_t kmeans_smem_bytes(int f, int k) { return smem_bytes(f, k); }

// Rows of points one block covers (the partials' leading dimension).
int kmeans_block_rows() { return kRows; }

const char* kmeans_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ids (n) int32, dmin (n) f32 for points (n, f) of type dtype (0 fp32, 1 bf16
// bits, 2 int8 with scales (f)) against fp32 centroids (k, f) and |c|^2 (k).
int kmeans_assign(int dtype, const void* pts, const void* cent, const void* c2,
                  const void* scales, int n, int f, int k, void* ids, void* dmin,
                  void* stream) {
  return dispatch<false>(dtype, pts, cent, c2, scales, n, f, k, ids, dmin,
                         nullptr, nullptr, static_cast<cudaStream_t>(stream));
}

// The fused form: also sums (k, f) and counts (k), through the scratch psums
// (nblocks, k, f) and pcounts (nblocks, k), nblocks = ceil(n / block rows).
int kmeans_assign_update(int dtype, const void* pts, const void* cent,
                         const void* c2, const void* scales, int n, int f, int k,
                         void* ids, void* dmin, void* psums, void* pcounts,
                         void* sums, void* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch<true>(dtype, pts, cent, c2, scales, n, f, k, ids,
                                   dmin, psums, pcounts, s);
  if (err != cudaSuccess) return err;
  const int nblocks = (n + kRows - 1) / kRows;
  const int kf = k * f;
  reduce_partials<<<(kf + k + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(psums), static_cast<const float*>(pcounts),
      nblocks, kf, k, static_cast<float*>(sums), static_cast<float*>(counts));
  return cudaGetLastError();
}

}  // extern "C"
