// Forward flash attention (GQA, causal, sliding window) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/flash_attention.py: the body
// _flash_kernel (:34) behind pl.pallas_call (:120), reached through
// flash_attention (:96).
//
// What it computes, for q (B,Sq,H,D) and k/v (B,Sk,Hkv,D) in the reference's
// layout, query head h reading kv head h / (H/Hkv):
//   s[i,j] = (q_i . k_j) / sqrt(D)   where kpos < Sk, and kpos <= qpos when
//                                    causal, and kpos > qpos - window when a
//                                    window is given; -inf elsewhere
//   o_i    = sum_j softmax(s_i)_j v_j, with an online softmax over key tiles;
//            a row with every key masked gives 0 (l clamped to 1e-20).
// Inputs are fp32 or bf16, read in their type; every product and sum is fp32;
// the output is written in q's type.
//
// What bounds it on an H100: it reads q, k and v once and writes o once,
// (2*B*Sq*H + 2*B*Sk*Hkv)*D elements, and does 4*D flops for each (query row,
// key) pair the masks leave open (2*D for q.k, 2*D for p.v).  At the serving
// path's widest wave (B 4, S 4096, H 25, D 64, window 2048) that is about 161
// GFLOP against about 0.27 GB, so it is bound by operations: about 2.4 ms at
// the 67 TFLOP/s of fp32 FMAs, against about 0.08 ms of bytes.
//
// What this design does about it: one block of 8 warps owns 64 query rows of
// one (batch, head); each warp owns 8 of them.  Key and value tiles of 64 rows
// are staged in shared memory as fp32 once per block and reused by all 64
// query rows; the running max, sum and the 8-row accumulator live in
// registers.  For q.k a lane owns two keys and reads four features at a time
// (16-byte loads, a row stride of D+4 floats so the 8 lanes of a load phase
// hit distinct banks; the q row is a broadcast).  For p.v a lane owns the
// features lane, lane+32, ..., and the probabilities of its warp's rows are a
// broadcast from a warp-private strip of shared memory.  That gives 8 FMAs
// per shared-memory load in both products.  Key tiles that lie wholly above
// the causal diagonal or wholly outside the window are not visited at all
// (the Pallas kernel masks them instead).  The math stays on the fp32 FMA
// pipes: tensor cores (mma/wgmma on bf16, TMA staging) are later work.
//
// C interface for ctypes: every pointer and the stream are void*, and the
// entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 64 query rows per block
constexpr int kBlockK = 64;                     // keys per staged tile

enum ElemType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Row stride of the staged tiles, in floats: 16-byte aligned, and D/4 + 1 odd
// 16-byte words, so 8 consecutive rows start in 8 distinct bank groups.
__host__ __device__ __forceinline__ int tile_stride(int d) { return d + 4; }

size_t smem_bytes(int d) {
  return sizeof(float) * (3 * static_cast<size_t>(kBlockQ) * tile_stride(d) +
                          static_cast<size_t>(kWarps) * kRowsPerWarp * kBlockK);
}

// Stage rows [row0, row0 + 64) of a (B,S,heads,D) tensor's (b, head) slice
// into a (64, stride) fp32 tile; rows at or beyond s are zero.
template <typename T>
__device__ __forceinline__ void stage_tile(float* dst, const T* __restrict__ src,
                                           int b, int head, int heads, int s,
                                           int row0, int d, int stride) {
  for (int i = threadIdx.x; i < kBlockQ * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    const int pos = row0 + r;
    float v = 0.0f;
    if (pos < s)
      v = to_f32(src[((static_cast<long>(b) * s + pos) * heads + head) * d + c]);
    dst[r * stride + c] = v;
  }
}

template <typename T, int kMaxD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                 int h, int hkv, int d, int causal, int window, float scale) {
  constexpr int kAcc = kMaxD / 32;  // features a lane owns in p.v
  extern __shared__ float smem[];
  const int stride = tile_stride(d);
  float* s_q = smem;                       // (64, stride)
  float* s_k = s_q + kBlockQ * stride;     // (64, stride)
  float* s_v = s_k + kBlockK * stride;     // (64, stride)
  float* s_p = s_v + kBlockK * stride;     // (warps, 8 rows, 64 keys)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int khead = head / (h / hkv);
  float* p_strip = s_p + warp * kRowsPerWarp * kBlockK;

  stage_tile(s_q, q, b, head, h, sq, q0, d, stride);

  // key tiles that any of this block's query rows can see
  const int q_last = min(q0 + kBlockQ, sq) - 1;
  int k_end = sk;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int kt_begin = k_begin / kBlockK;
  const int kt_end = (k_end + kBlockK - 1) / kBlockK;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kAcc];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int a = 0; a < kAcc; ++a) acc[r][a] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    stage_tile(s_k, k, b, khead, hkv, sk, k0, d, stride);
    stage_tile(s_v, v, b, khead, hkv, sk, k0, d, stride);
    __syncthreads();

    // scores of this warp's 8 rows against keys lane and lane + 32
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.0f;
    const float* k_a = s_k + lane * stride;
    const float* k_b = s_k + (lane + 32) * stride;
    const float* q_w = s_q + warp * kRowsPerWarp * stride;
    for (int c = 0; c < d; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(k_a + c);
      const float4 kb = *reinterpret_cast<const float4*>(k_b + c);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_w + r * stride + c);
        s[r][0] = fmaf(qv.x, ka.x, s[r][0]);
        s[r][0] = fmaf(qv.y, ka.y, s[r][0]);
        s[r][0] = fmaf(qv.z, ka.z, s[r][0]);
        s[r][0] = fmaf(qv.w, ka.w, s[r][0]);
        s[r][1] = fmaf(qv.x, kb.x, s[r][1]);
        s[r][1] = fmaf(qv.y, kb.y, s[r][1]);
        s[r][1] = fmaf(qv.z, kb.z, s[r][1]);
        s[r][1] = fmaf(qv.w, kb.w, s[r][1]);
      }
    }

    // masks and the online softmax update, one row at a time
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = q0 + warp * kRowsPerWarp + r;
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + lane + 32 * e;
        bool keep = kpos < sk;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        s[r][e] = keep ? s[r][e] * scale : -INFINITY;
        mx = fmaxf(mx, s[r][e]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      float psum = 0.0f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = s[r][e] == -INFINITY ? 0.0f : expf(s[r][e] - m_safe);
        p_strip[r * kBlockK + lane + 32 * e] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float corr = m[r] == -INFINITY ? 0.0f : expf(m[r] - m_safe);
      l[r] = l[r] * corr + psum;
      m[r] = m_new;
#pragma unroll
      for (int a = 0; a < kAcc; ++a) acc[r][a] *= corr;
    }
    __syncwarp();

    // acc += p . v over the tile's keys, four keys at a time
    for (int j = 0; j < kBlockK; j += 4) {
      float4 p4[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        p4[r] = *reinterpret_cast<const float4*>(p_strip + r * kBlockK + j);
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
        const int c = lane + 32 * a;
        if (c < d) {
          const float v0 = s_v[(j + 0) * stride + c];
          const float v1 = s_v[(j + 1) * stride + c];
          const float v2 = s_v[(j + 2) * stride + c];
          const float v3 = s_v[(j + 3) * stride + c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            float t = acc[r][a];
            t = fmaf(p4[r].x, v0, t);
            t = fmaf(p4[r].y, v1, t);
            t = fmaf(p4[r].z, v2, t);
            t = fmaf(p4[r].w, v3, t);
            acc[r][a] = t;
          }
        }
      }
    }
    __syncwarp();  // the strip is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = q0 + warp * kRowsPerWarp + r;
    if (qpos >= sq) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-20f);
    T* out = o + ((static_cast<long>(b) * sq + qpos) * h + head) * d;
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int c = lane + 32 * a;
      if (c < d) store(out + c, acc[r][a] * inv);
    }
  }
}

template <typename T, int kMaxD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int sq, int sk, int h, int hkv, int d, int causal,
                   int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, kMaxD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, h, b);
  flash_kernel<T, kMaxD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, hkv, d, causal,
      window, 1.0f / sqrtf(static_cast<float>(d)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(const void* q, const void* k, const void* v, void* o,
                     int b, int sq, int sk, int h, int hkv, int d, int causal,
                     int window, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, b, sq, sk, h, hkv, d, causal, window,
                         stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, b, sq, sk, h, hkv, d, causal, window,
                          stream);
  return launch<T, 256>(q, k, v, o, b, sq, sk, h, hkv, d, causal, window,
                        stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at head width d.
size_t flash_smem_bytes(int d) { return smem_bytes(d); }

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// o (b, sq, h, d) = attention of q (b, sq, h, d) over k/v (b, sk, hkv, d),
// all contiguous and of one type (0 fp32, 1 bf16); d a multiple of 16 up to
// 256; window <= 0 means no window.
int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                        void* o, int b, int sq, int sk, int h, int hkv, int d,
                        int causal, int window, void* stream) {
  if (d <= 0 || d > 256 || d % 16 != 0 || hkv <= 0 || h % hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return by_width<float>(q, k, v, o, b, sq, sk, h, hkv, d, causal, window,
                             s);
    case kBF16:
      return by_width<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, hkv, d, causal,
                                     window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
