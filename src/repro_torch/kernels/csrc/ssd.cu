// Mamba2 SSD, the part inside each chunk, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/ssd.py: the body _ssd_kernel
// (:31) behind pl.pallas_call (:92), reached through ssd_chunk_scan (:70).
// The recurrence across chunks and the y_inter product stay in PyTorch, as
// the reference keeps them outside its kernel (:120-137).
//
// What it computes, for one (batch b, head h, chunk c) of q positions, with
// head h reading B/C group h / (nh/g), dt after softplus and A < 0:
//   cum_i  = sum_{t <= i} dt_t * A                       (a block scan)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j  +  D x_i
//   st     = sum_j B_j^T (exp(cum_{q-1} - cum_j) dt_j x_j)          (ds, hd)
// and writes y (B,S,nh,hd) in x's type, st (B,nh,nc,ds,hd) fp32 and cum
// (B,nh,nc,q) fp32.  The chunk length q is any value up to 256.
//
// What bounds it on an H100: per (b, h, chunk) the function needs
// 2*(ds + hd) flops for each of the q*(q+1)/2 causal pairs j <= i, plus
// 2*q*ds*hd for the state, and moves x (q*hd), dt, B and C (q*ds each) in
// and y, st and cum out once.  At hymba-1.5b's widths (q 256, hd 64, ds 16)
// that is 34 fp32 flops per byte moved, above the card's fp32 ridge of 20,
// so it is bound by operations: about 18.5 GFLOP for the serving path's
// widest wave (B 4, S 4096, 50 heads), about 0.28 ms at the 67 TFLOP/s of
// fp32 FMAs.  The kernel computes the diagonal 64 x 64 tiles whole, so it
// does somewhat more than that.
//
// What this design does about it: one block of 256 threads owns one
// (b, h, chunk).  The decay cum is a warp-shuffle block scan, never a tril
// matrix.  The quadratic part runs over 64-row tiles: for a tile of output
// rows i the block stages C_i, then for every key tile j <= i it stages B_j
// and x_j, forms M = (C_i B_j^T) o L on the fly in a 64 x 64 shared tile
// (exp(cum_i - cum_j) dt_j below the diagonal, 0 above), and accumulates
// M x_j into registers; the tile of M is never written to device memory.
// The chunk state is a second pass over the key tiles.  B, C and x are staged
// tile by tile, so the block holds at most 2*64*(ds+4) + 64*hd + 64*68 floats
// (103 KB at mamba2-130m's ds 128): a whole chunk of fp32 B, C and x would
// not fit.  The 16-byte loads of B and C rows use a stride of ds+4 floats,
// which keeps the 8 lanes of a load phase on distinct banks.  All math is
// fp32 FMAs; tensor cores are later work.
//
// C interface for ctypes: every pointer and the stream are void*, and the
// entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;        // rows of a staged tile (i and j alike)
constexpr int kMaxChunk = 256;
constexpr int kRowsPerWarp = kTile / kWarps;  // 8 output rows per warp
constexpr int kMStride = kTile + 4;

enum ElemType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__host__ __device__ __forceinline__ int bc_stride(int ds) { return ds + 4; }

size_t smem_bytes(int hd, int ds) {
  return sizeof(float) *
         (2 * kMaxChunk + 2 * static_cast<size_t>(kTile) * bc_stride(ds) +
          static_cast<size_t>(kTile) * hd + kTile * kMStride);
}

struct Dims {
  int s, nh, hd, g, ds, q, nc, rep;
};

// Stage rows [t0, t0 + 64) of the chunk from a (B,S,heads,width) tensor's
// (b, head) slice into a (64, stride) fp32 tile; rows at or past q are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      long row_base, int heads, int head,
                                      int width, int stride, int t0, int q) {
  for (int e = threadIdx.x; e < kTile * width; e += kThreads) {
    const int r = e / width;
    const int c = e - r * width;
    const int t = t0 + r;
    float v = 0.0f;
    if (t < q) v = to_f32(src[((row_base + t) * heads + head) * width + c]);
    dst[r * stride + c] = v;
  }
}

template <typename T, int kMaxHd>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const float* __restrict__ Dv,
                     Dims dims, T* __restrict__ y, float* __restrict__ st,
                     float* __restrict__ cum_out) {
  constexpr int kCols = kMaxHd / 32;  // output columns a lane owns
  extern __shared__ float smem[];
  const int q = dims.q, hd = dims.hd, ds = dims.ds;
  const int sstride = bc_stride(ds);
  float* s_cum = smem;                       // (256)
  float* s_dt = s_cum + kMaxChunk;           // (256)
  float* s_c = s_dt + kMaxChunk;             // (64, ds + 4)
  float* s_b = s_c + kTile * sstride;        // (64, ds + 4)
  float* s_x = s_b + kTile * sstride;        // (64, hd)
  float* s_m = s_x + kTile * hd;             // (64, 68)
  __shared__ float s_warp[kWarps];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / dims.rep;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long row_base = static_cast<long>(b) * dims.s + static_cast<long>(c) * q;
  const float a = A[h];

  // cum = inclusive scan of dt * A over the chunk (one position a thread)
  float dtv = 0.0f;
  if (tid < q) dtv = dt[(row_base + tid) * dims.nh + h];
  float v = dtv * a;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  float prefix = 0.0f;
  for (int w = 0; w < warp; ++w) prefix += s_warp[w];
  v += prefix;
  if (tid < q) {
    s_cum[tid] = v;
    s_dt[tid] = dtv;
    cum_out[((static_cast<long>(b) * dims.nh + h) * dims.nc + c) * q + tid] = v;
  }
  __syncthreads();
  const float total = s_cum[q - 1];

  // ---- y: intra-chunk product, tile of rows i against key tiles j <= i ----
  const int ntiles = (q + kTile - 1) / kTile;
  for (int it = 0; it < ntiles; ++it) {
    const int i0 = it * kTile;
    float acc[kRowsPerWarp][kCols];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[r][k] = 0.0f;
    __syncthreads();  // the previous pass is done with s_c
    stage(s_c, Cm, row_base, dims.g, grp, ds, sstride, i0, q);
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();  // everyone is done with s_b, s_x, s_m
      stage(s_b, Bm, row_base, dims.g, grp, ds, sstride, j0, q);
      stage(s_x, x, row_base, dims.nh, h, hd, hd, j0, q);
      __syncthreads();
      // M[i][j] for j = tid % 64 and rows i = (tid / 64) * 16 + 0..15
      {
        const int j = tid % kTile;
        const int ib = (tid / kTile) * 16;
        float g[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) g[r] = 0.0f;
        const float* brow = s_b + j * sstride;
        for (int n = 0; n < ds; n += 4) {
          const float4 bv = *reinterpret_cast<const float4*>(brow + n);
#pragma unroll
          for (int r = 0; r < 16; ++r) {
            const float4 cv =
                *reinterpret_cast<const float4*>(s_c + (ib + r) * sstride + n);
            g[r] = fmaf(cv.x, bv.x, g[r]);
            g[r] = fmaf(cv.y, bv.y, g[r]);
            g[r] = fmaf(cv.z, bv.z, g[r]);
            g[r] = fmaf(cv.w, bv.w, g[r]);
          }
        }
        const int jg = j0 + j;
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const int ig = i0 + ib + r;
          float mv = 0.0f;
          if (ig < q && jg < q && ig >= jg)
            mv = g[r] * (expf(s_cum[ig] - s_cum[jg]) * s_dt[jg]);
          s_m[(ib + r) * kMStride + j] = mv;
        }
      }
      __syncthreads();
      // acc[i][p] += sum_j M[i][j] x[j][p]; a warp owns 8 rows, a lane the
      // columns lane, lane + 32, ...
      const float* m_w = s_m + warp * kRowsPerWarp * kMStride;
      for (int jj = 0; jj < kTile; jj += 4) {
        float4 m4[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          m4[r] = *reinterpret_cast<const float4*>(m_w + r * kMStride + jj);
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int p = lane + 32 * k;
          if (p < hd) {
            const float x0 = s_x[(jj + 0) * hd + p];
            const float x1 = s_x[(jj + 1) * hd + p];
            const float x2 = s_x[(jj + 2) * hd + p];
            const float x3 = s_x[(jj + 3) * hd + p];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
              float t = acc[r][k];
              t = fmaf(m4[r].x, x0, t);
              t = fmaf(m4[r].y, x1, t);
              t = fmaf(m4[r].z, x2, t);
              t = fmaf(m4[r].w, x3, t);
              acc[r][k] = t;
            }
          }
        }
      }
    }
    // y = acc + D x (x of row i read back from device memory)
    const float dh = Dv[h];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = i0 + warp * kRowsPerWarp + r;
      if (i >= q) continue;
      const long off = ((row_base + i) * dims.nh + h) * hd;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int p = lane + 32 * k;
        if (p < hd) store(y + off + p, acc[r][k] + to_f32(x[off + p]) * dh);
      }
    }
  }

  // ---- chunk state: st[n][p] = sum_j B[j][n] w_j x[j][p] ----
  // rows n in passes of 64 (8 a warp), columns p as above
  float* st_out = st + (((static_cast<long>(b) * dims.nh + h) * dims.nc + c) *
                        ds) * hd;
  for (int n0 = 0; n0 < ds; n0 += kTile) {
    float acc[kRowsPerWarp][kCols];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[r][k] = 0.0f;
    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();
      stage(s_b, Bm, row_base, dims.g, grp, ds, sstride, j0, q);
      stage(s_x, x, row_base, dims.nh, h, hd, hd, j0, q);
      // fold w_j = exp(total - cum_j) dt_j into the staged x rows
      for (int e = tid; e < kTile * hd; e += kThreads) {
        const int jg = j0 + e / hd;
        if (jg < q) s_x[e] *= expf(total - s_cum[jg]) * s_dt[jg];
      }
      __syncthreads();
      for (int j = 0; j < kTile && j0 + j < q; ++j) {
        float bn[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int n = n0 + warp * kRowsPerWarp + r;
          bn[r] = n < ds ? s_b[j * sstride + n] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int p = lane + 32 * k;
          if (p < hd) {
            const float xv = s_x[j * hd + p];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r)
              acc[r][k] = fmaf(bn[r], xv, acc[r][k]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int n = n0 + warp * kRowsPerWarp + r;
      if (n >= ds) continue;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int p = lane + 32 * k;
        if (p < hd) st_out[static_cast<long>(n) * hd + p] = acc[r][k];
      }
    }
  }
}

template <typename T, int kMaxHd>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* Dv, int b, const Dims& dims,
                   void* y, void* st, void* cum, cudaStream_t stream) {
  const size_t smem = smem_bytes(dims.hd, dims.ds);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, kMaxHd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(dims.nc, dims.nh, b);
  ssd_chunk_kernel<T, kMaxHd><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(Dv), dims,
      static_cast<T*>(y), static_cast<float*>(st), static_cast<float*>(cum));
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, const void* Dv, int b,
                     const Dims& dims, void* y, void* st, void* cum,
                     cudaStream_t stream) {
  if (dims.hd <= 64)
    return launch<T, 64>(x, dt, A, Bm, Cm, Dv, b, dims, y, st, cum, stream);
  if (dims.hd <= 128)
    return launch<T, 128>(x, dt, A, Bm, Cm, Dv, b, dims, y, st, cum, stream);
  return launch<T, 256>(x, dt, A, Bm, Cm, Dv, b, dims, y, st, cum, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at head width hd and state width ds.
size_t ssd_smem_bytes(int hd, int ds) { return smem_bytes(hd, ds); }

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (b, s, nh, hd) and B/C (b, s, g, ds) of one type (0 fp32, 1 bf16), dt
// (b, s, nh), A and D (nh) fp32, all contiguous; s = nc * q, q <= 256,
// hd <= 256, ds a multiple of 4 up to 256.  Writes y (b, s, nh, hd) in x's
// type, st (b, nh, nc, ds, hd) and cum (b, nh, nc, q) fp32.
int ssd_chunk_fwd(int dtype, const void* x, const void* dt, const void* A,
                  const void* Bm, const void* Cm, const void* Dv, int b, int s,
                  int nh, int hd, int g, int ds, int q, void* y, void* st,
                  void* cum, void* stream) {
  if (q <= 0 || q > kMaxChunk || s % q != 0 || hd <= 0 || hd > 256 ||
      ds <= 0 || ds > 256 || ds % 4 != 0 || g <= 0 || nh % g != 0)
    return cudaErrorInvalidValue;
  const Dims dims{s, nh, hd, g, ds, q, s / q, nh / g};
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return by_width<float>(x, dt, A, Bm, Cm, Dv, b, dims, y, st, cum, st_);
    case kBF16:
      return by_width<__nv_bfloat16>(x, dt, A, Bm, Cm, Dv, b, dims, y, st, cum,
                                     st_);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
