// Forward flash attention (GQA, causal, sliding window) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/flash_attention.py: the body
// _flash_kernel (:34) behind pl.pallas_call (:120), reached through
// flash_attention (:96).
//
// What it computes, for q (B,Sq,H,D) and k/v (B,Sk,Hkv,D) in the reference's
// layout, query head h reading kv head h / (H/Hkv):
//   s[i,j] = (q_i . k_j) * scale     (1 / sqrt(D) unless the caller gives
//                                    one) where kpos < Sk, and kpos <= qpos when
//                                    causal, and kpos > qpos - window when a
//                                    window is given; -inf elsewhere
//   o_i    = sum_j softmax(s_i)_j v_j, with an online softmax over key tiles;
//            a row with every key masked gives 0 (l clamped to 1e-20).
// Every product and sum is fp32, as in the reference (which casts q, k, v to
// fp32 and forms p.v with fp32 p); the output is written in q's type.
//
// What bounds it on an H100: it reads q, k and v once and writes o once,
// (2*B*Sq*H + 2*B*Sk*Hkv)*D elements, and does 4*D flops for each (query row,
// key) pair the masks leave open.  At the serving path's widest wave (B 4,
// S 4096, H 25/5, D 64, window 2048) that is about 161 GFLOP against about
// 0.27 GB (fp32) or 0.13 GB (bf16): bound by operations in both types, 2.4 ms
// at the 67 TFLOP/s of fp32 FMAs, 0.16 ms at the 989 TFLOP/s of bf16 tensor
// cores.  Both designs skip key tiles that lie wholly above the causal
// diagonal or outside the window, and mask only the edge tiles.
//
// Two designs, one per input type:
//
// fp32 (flash_f32): the products stay exact fp32 FMAs (no TF32), bound by
//   the FMA pipes.  A block of 8 warps owns 128 query rows of one (batch,
//   head); thread (tr, tc) owns rows tr, tr+32, tr+64, tr+96 and, of each key
//   tile, keys tc, tc+8, ...  Q is staged once; K and V flow through a
//   two-slot ring of 16-byte cp.async copies over the stream K0, V0, K1, V1,
//   ...: K(t+1) loads while the softmax and p.v of tile t run, V(t+1) while
//   q.k of tile t+1 runs.  S is a 4x8 register micro-tile, an outer product
//   over d: 4 q and 8 k float4 loads feed 128 FMAs.  The row max and sum
//   reduce over the 8 lanes that share a row.  p goes to a strip of shared
//   memory that only its own warp reads back, and O is a 4 x D/8 register
//   micro-tile: per 4 keys, 4 float4 loads of p and D/16 of v feed D/2 FMAs.
//   exp is ex2.approx on the special-function unit (2 ulp).  D 64: 64-key
//   tiles, 106,496 B of shared memory and 128 registers a thread (ptxas,
//   with a few dozen bytes of spill), so 2 blocks and 16 warps an SM; D 128
//   and 256: 32-key tiles, 121,856 and 220,160 B, 1 block.
//
// bf16 (flash_bf16): warp-specialised wgmma, bound by the tensor cores.  A
//   persistent block of 3 warpgroups (one an SM) walks work items of 128
//   query rows of one (batch, head), heaviest first and dealt to the blocks
//   in snake order, so their totals even out.  Warpgroups 0 and 1 consume
//   64 rows each, warpgroup 2 produces: one thread loads each item's Q tile
//   once the previous item's last S has read it, and streams K/V tiles of
//   128 keys (64 at D 192/256) with TMA (cp.async.bulk.tensor, 128-byte
//   swizzle) into a 3-stage ring (2 at D 256) guarded by full/empty
//   mbarriers; the ring runs
//   on across items, so the next item's tiles load during this one's tail.
//   S = Q.K^T is wgmma.m64nNk16 with fp32 accumulators, both operands read
//   from shared memory; the online softmax runs on the accumulator
//   fragments in registers (a row lives in the 4 lanes of a quad) with the
//   reference's m_safe, corr and l >= 1e-20 guards.  O += P.V takes P from
//   registers as wgmma's A operand.  p stays fp32 in the reference, so it is
//   split into p_hi = bf16(p) and p_lo = bf16(p - p_hi) and both go through
//   the tensor cores into the same fp32 accumulator: about 16 bits of p, an
//   error near 2^-17 of each term instead of 2^-9, for 1.5x the tensor-core
//   work.  The two consumer warpgroups take turns issuing S (named
//   barriers), so one's softmax runs while the other's products do.
//   setmaxnreg moves registers from the producer (24) to the consumers
//   (240), but ptxas allocates at most 168 a thread for the kernel: S, P
//   and O fit with no spill at every width (ptxas), while a pipelined loop
//   that issued S(t+1) beside P(t).V(t) did not fit (ptxas spilled and
//   serialised its wgmmas) and ran slower.  Shared memory: 115,776 B at
//   D 64, 230,464 B at D 128, 197,696 B at D 192 and 256.
//   D not a multiple of 64 loads zero-filled columns (TMA fills
//   out-of-range elements with 0).
//
// Neither design uses atomics: a launch's result does not depend on timing.
// A wait on an mbarrier that spins far longer than any load can take traps
// (the launch fails with a CUDA error) instead of hanging the card.
//
// C interface for ctypes: every pointer and the stream are void*, and the
// entry point returns cudaGetLastError() after its launch (or the CUresult of
// building a TMA descriptor, offset by kTensorMapErrorBase).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum ElemType { kF32 = 0, kBF16 = 1 };
constexpr int kTensorMapErrorBase = 100000;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (2 ulp); 2^-inf is 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// True when every (query row in [q0, q_last], key in [k0, k0 + nk)) pair of
// a tile is open, so the tile needs no mask.
__device__ __forceinline__ bool tile_is_open(int q0, int q_last, int k0,
                                             int nk, int sk, int causal,
                                             int window) {
  bool open = k0 + nk <= sk;
  if (causal) open = open && k0 + nk - 1 <= q0;
  if (window > 0) open = open && k0 > q_last - window;
  return open;
}

__device__ __forceinline__ bool key_open(int qpos, int kpos, int sk,
                                         int causal, int window) {
  bool keep = kpos < sk;
  if (causal) keep = keep && kpos <= qpos;
  if (window > 0) keep = keep && kpos > qpos - window;
  return keep;
}

// Key tiles [kt_begin, kt_end) of size nk that any query row of
// [q0, q_last] can see.
__device__ __forceinline__ void key_tiles(int q0, int q_last, int sk,
                                          int causal, int window, int nk,
                                          int* kt_begin, int* kt_end) {
  int k_end = sk;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  *kt_begin = k_begin / nk;
  *kt_end = k_begin < k_end ? (k_end + nk - 1) / nk : *kt_begin;
}

// ---------------------------------------------------------------------------
// fp32: register micro-tiles fed from a cp.async ring
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kRowGroups = 32;              // tr: 0..31
constexpr int kThreads = kRowGroups * 8;    // tc: 0..7 -> 256 threads
constexpr int kRowsPerThread = 4;
constexpr int kRows = kRowGroups * kRowsPerThread;  // 128 query rows

template <int kMaxD> struct Cfg {
  static constexpr int kKeys = kMaxD <= 64 ? 64 : 32;   // keys a tile
  static constexpr int kMinBlocks = kMaxD <= 128 ? 2 : 1;
};

// Row stride of the staged tiles, in floats: 16-byte aligned, and rows that
// are 8 apart start in distinct 16-byte bank groups.
__host__ __device__ __forceinline__ int stride(int d) { return d + 4; }

// Row stride of the p strip: rows 8 apart start 8 banks apart, so the 32
// (row, key) stores of a warp hit distinct banks.
__host__ __device__ constexpr int p_stride(int keys) { return keys + 8; }

size_t smem_bytes(int d, int keys) {
  return sizeof(float) * (static_cast<size_t>(kRows + 2 * keys) * stride(d) +
                          kRows * p_stride(keys));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Queue 16-byte copies of rows [row0, row0 + nrows) of the (b, head) slice
// of a (B, s, heads, d) tensor into a (nrows, stride) tile; rows at or past
// s are filled with zeros.  kMaxD/4 chunks a row, so the row and chunk of a
// copy come from a shift and a mask.
template <int kMaxD>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int b, int head, int heads, int s,
                                      int row0, int nrows, int d) {
  constexpr int kChunks = kMaxD / 4;
  const int sd = stride(d);
  for (int i = threadIdx.x; i < nrows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    if (4 * c >= d) continue;
    const int pos = row0 + r;
    const int src_pos = min(pos, s - 1);
    const float* g =
        src + ((static_cast<long>(b) * s + src_pos) * heads + head) * d + 4 * c;
    cp_async16(dst + r * sd + 4 * c, g, pos < s ? 16 : 0);
  }
}

// kExact: d == kMaxD, so no column of O needs a bound check.
template <int kMaxD, bool kExact>
__global__ void __launch_bounds__(kThreads, Cfg<kMaxD>::kMinBlocks)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int sq,
              int sk, int h, int hkv, int d, int causal, int window,
              float scale) {
  constexpr int kKeys = Cfg<kMaxD>::kKeys;
  constexpr int kKeysPerThread = kKeys / 8;
  constexpr int kCol4 = kMaxD / 32;  // float4 columns of O a thread owns
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int sd = stride(d);
  float* s_q = smem;                   // (kRows, sd)
  float* s_k = s_q + kRows * sd;       // (kKeys, sd): ring slot 0
  float* s_v = s_k + kKeys * sd;       // (kKeys, sd): ring slot 1
  float* s_p = s_v + kKeys * sd;       // (kRows, kKeys + 8): p
  constexpr int ps = p_stride(kKeys);

  const int tid = threadIdx.x;
  const int tr = tid / 8;
  const int tc = tid % 8;
  // the heaviest query tiles (most keys under the causal mask) go first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int khead = head / (h / hkv);
  const int q_last = min(q0 + kRows, sq) - 1;
  int kt_begin, kt_end;
  key_tiles(q0, q_last, sk, causal, window, kKeys, &kt_begin, &kt_end);

  float m[kRowsPerThread], l[kRowsPerThread];
  float4 acc[kRowsPerThread][kCol4];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCol4; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // ring: group {Q, K0}, then group {V0}
  stage<kMaxD>(s_q, q, b, head, h, sq, q0, kRows, d);
  if (kt_begin < kt_end)
    stage<kMaxD>(s_k, k, b, khead, hkv, sk, kt_begin * kKeys, kKeys, d);
  cp_async_commit();
  if (kt_begin < kt_end)
    stage<kMaxD>(s_v, v, b, khead, hkv, sk, kt_begin * kKeys, kKeys, d);
  cp_async_commit();

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    cp_async_wait_1();  // K(kt) has landed; V(kt) may still be in flight
    __syncthreads();

    // S micro-tile: rows tr + 24i, keys tc + 8jj
    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) s[i][jj] = 0.0f;
#pragma unroll 1
    for (int c = 0; c < d; c += 4) {
      float4 qv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            s_q + (tr + kRowGroups * i) * sd + c);
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) {
        const float4 kv =
            *reinterpret_cast<const float4*>(s_k + (tc + 8 * jj) * sd + c);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          float t = s[i][jj];
          t = fmaf(qv[i].x, kv.x, t);
          t = fmaf(qv[i].y, kv.y, t);
          t = fmaf(qv[i].z, kv.z, t);
          t = fmaf(qv[i].w, kv.w, t);
          s[i][jj] = t;
        }
      }
    }
    __syncthreads();  // every warp is done with slot 0
    if (kt + 1 < kt_end)
      stage<kMaxD>(s_k, k, b, khead, hkv, sk, k0 + kKeys, kKeys, d);
    cp_async_commit();

    // masks (edge tiles only) and the online softmax, one row at a time
    const bool open = tile_is_open(q0, q_last, k0, kKeys, sk, causal, window);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int qpos = q0 + tr + kRowGroups * i;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) {
        const bool keep =
            open || key_open(qpos, k0 + tc + 8 * jj, sk, causal, window);
        s[i][jj] = keep ? s[i][jj] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][jj]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      // p = exp(s - m_safe) = 2^(s log2 e - m_safe log2 e), on the
      // special-function unit (2 ulp); a masked s of -inf gives 0
      const float nm = -m_safe * kLog2e;
      float psum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) {
        s[i][jj] = ex2(fmaf(s[i][jj], kLog2e, nm));
        psum += s[i][jj];
        s_p[(tr + kRowGroups * i) * ps + tc + 8 * jj] = s[i][jj];
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      const float corr =
          m[i] == -INFINITY ? 0.0f : ex2((m[i] - m_safe) * kLog2e);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCol4; ++j) {
        acc[i][j].x *= corr;
        acc[i][j].y *= corr;
        acc[i][j].z *= corr;
        acc[i][j].w *= corr;
      }
    }

    cp_async_wait_1();  // V(kt) has landed; K(kt+1) may still be in flight
    __syncthreads();
    // O micro-tile += p . v, four keys at a time: a row's p is a broadcast
    // from the strip its own warp wrote
    __syncwarp();
#pragma unroll 4
    for (int j4 = 0; j4 < kKeys; j4 += 4) {
      float4 p4[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        p4[i] = *reinterpret_cast<const float4*>(
            s_p + (tr + kRowGroups * i) * ps + j4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = s_v + (j4 + e) * sd;
#pragma unroll
        for (int j = 0; j < kCol4; ++j) {
          const int col = 4 * (tc + 8 * j);
          if (kExact || col < d) {
            const float4 vv = *reinterpret_cast<const float4*>(vrow + col);
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i) {
              const float p = e == 0 ? p4[i].x : e == 1 ? p4[i].y
                            : e == 2 ? p4[i].z : p4[i].w;
              acc[i][j].x = fmaf(p, vv.x, acc[i][j].x);
              acc[i][j].y = fmaf(p, vv.y, acc[i][j].y);
              acc[i][j].z = fmaf(p, vv.z, acc[i][j].z);
              acc[i][j].w = fmaf(p, vv.w, acc[i][j].w);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with slot 1
    if (kt + 1 < kt_end)
      stage<kMaxD>(s_v, v, b, khead, hkv, sk, k0 + kKeys, kKeys, d);
    cp_async_commit();
  }

  asm volatile("cp.async.wait_all;\n" ::: "memory");  // Q when no tile ran

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int qpos = q0 + tr + kRowGroups * i;
    if (qpos >= sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-20f);
    float* out = o + ((static_cast<long>(b) * sq + qpos) * h + head) * d;
#pragma unroll
    for (int j = 0; j < kCol4; ++j) {
      const int col = 4 * (tc + 8 * j);
      if (kExact || col < d)
        *reinterpret_cast<float4*>(out + col) =
            make_float4(acc[i][j].x * inv, acc[i][j].y * inv,
                        acc[i][j].z * inv, acc[i][j].w * inv);
    }
  }
}

template <int kMaxD, bool kExact>
cudaError_t launch_as(const void* q, const void* k, const void* v, void* o,
                      int b, int sq, int sk, int h, int hkv, int d, int causal,
                      int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, Cfg<kMaxD>::kKeys);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32<kMaxD, kExact>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kRows - 1) / kRows, h, b);
  flash_f32<kMaxD, kExact><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, h, hkv, d,
      causal, window, scale);
  return cudaGetLastError();
}

template <int kMaxD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int sq, int sk, int h, int hkv, int d, int causal,
                   int window, float scale, cudaStream_t stream) {
  if (d == kMaxD)
    return launch_as<kMaxD, true>(q, k, v, o, b, sq, sk, h, hkv, d, causal,
                                  window, scale, stream);
  return launch_as<kMaxD, false>(q, k, v, o, b, sq, sk, h, hkv, d, causal,
                                 window, scale, stream);
}

size_t smem_for(int d) {
  return smem_bytes(d, d <= 64 ? Cfg<64>::kKeys
                       : d <= 128 ? Cfg<128>::kKeys : Cfg<256>::kKeys);
}

cudaError_t by_width(const void* q, const void* k, const void* v, void* o,
                     int b, int sq, int sk, int h, int hkv, int d, int causal,
                     int window, float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch<64>(q, k, v, o, b, sq, sk, h, hkv, d, causal, window, scale,
                      stream);
  if (d <= 128)
    return launch<128>(q, k, v, o, b, sq, sk, h, hkv, d, causal, window,
                       scale, stream);
  return launch<256>(q, k, v, o, b, sq, sk, h, hkv, d, causal, window, scale,
                     stream);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma with a TMA ring
// ---------------------------------------------------------------------------
namespace bf16 {

// wgmma.m64nNk16 with fp32 accumulators d (N/2 a thread); scale_d 0
// overwrites d.  SS: A and B from shared memory, both K-major.  RS: A from
// registers (4 bf16x2 a thread, K-major), B from shared memory, MN-major
// (trans-b 1).

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// wait that lasts 4 s (no load takes a millisecond) traps, so a fault in the
// ring fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0)
      t0 = now;
    else if (now - t0 > 4000000000ull)
      __trap();
  }
}

// One TMA box of a 4-D tensor map (d, heads, seq, batch) into shared memory,
// completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// Named barriers 1 and 2 hand the tensor cores from one consumer
// warpgroup to the other (256 threads: one warpgroup syncs, the other
// arrives), so one's softmax runs while the other's products do.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from reading (or writing) accumulators across a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 192) wgmma_rs_n192(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int kThreads = 384;   // consumer warpgroups 0 and 1, producer 2
constexpr int kBlockQ = 128;    // query rows: 64 a consumer warpgroup

// kD: head width the block computes (D rounded up to 64); kBN: keys a tile;
// kStages: depth of the K/V ring.
template <int kD, int kBN>
struct Cfg {
  static constexpr int kStages = kD <= 192 ? 3 : 2;
  static constexpr int kChunks = kD / 64;             // 128-byte columns
  static constexpr uint32_t kQHalf = 64u * kD * 2;    // a consumer's Q rows
  static constexpr uint32_t kTile = kBN * kD * 2u;    // one K or V tile
  static constexpr uint32_t kChunkRows = kBN * 128u;  // one column of a tile
  static constexpr size_t kSmem =
      1024 + 2 * kQHalf + 2 * kStages * kTile + 16 * kStages + 16;
};

// A consumer thread's rows: row0 and row0 + 8 of its warpgroup's 64, in the
// wgmma accumulator layout, where s[4n + 2r + j] is (row0 + 8r, key
// 8n + col0 + j) of the tile.
struct Rows {
  int row0, col0, wq0, wq_last;
};

// S = Q K^T for one tile, both operands K-major: a k16 step is 32 bytes
// into a 128-byte row, the next 64 columns are the next chunk.
template <int kD, int kBN>
__device__ __forceinline__ void issue_s(float (&s)[kBN / 2], uint32_t q_half,
                                        uint32_t k_tile) {
  using C = Cfg<kD, kBN>;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks)
    mma_ss<kBN>(s,
                desc_sw128(q_half + (ks / 4) * 8192u + (ks % 4) * 32u, 16,
                           1024),
                desc_sw128(k_tile + (ks / 4) * C::kChunkRows + (ks % 4) * 32u,
                           16, 1024),
                ks > 0);
}

// O += P V for one tile: V is MN-major (d contiguous); a k16 step is 16
// rows of 128 bytes, the next 64 columns of d are kChunkRows further.  P is
// the hi/lo pair, both through the tensor cores into the fp32 sum.
template <int kD, int kBN>
__device__ __forceinline__ void issue_pv(float (&acc)[kD / 2],
                                         const uint32_t (&p_hi)[kBN / 16][4],
                                         const uint32_t (&p_lo)[kBN / 16][4],
                                         uint32_t v_tile) {
  using C = Cfg<kD, kBN>;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t dv = desc_sw128(v_tile + kk * 2048u, C::kChunkRows, 1024);
    mma_rs<kD>(acc, p_hi[kk], dv);
    mma_rs<kD>(acc, p_lo[kk], dv);
  }
}

// The online softmax of one tile on the accumulator fragments: masks on an
// edge tile, the running max (in the reference's units, s * scale), corr,
// and s overwritten by p = exp(s * scale - m_safe) in fp32; l takes the sum
// of p.  A row's values live in the 4 lanes of a quad.
template <int kBN>
__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const Rows& w, int k0, int sk,
                                             int causal, int window,
                                             float scale) {
  if (!tile_is_open(w.wq0, w.wq_last, k0, kBN, sk, causal, window)) {
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (!key_open(w.row0 + 8 * r, k0 + 8 * n + w.col0 + j, sk, causal,
                        window))
            s[4 * n + 2 * r + j] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r] = fmaxf(mx[r], fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
  const float scale_log2 = scale * kLog2e;
  float nm[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale);
    const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
    corr[r] = m[r] == -INFINITY ? 0.0f : ex2((m[r] - m_safe) * kLog2e);
    m[r] = m_new;
    nm[r] = -m_safe * kLog2e;
  }
  // a masked s of -inf gives p = 0
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float& x = s[4 * n + 2 * r + j];
        x = ex2(fmaf(x, scale_log2, nm[r]));
        psum[r] += x;
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
    l[r] = l[r] * corr[r] + psum[r];
  }
}

// p as a bf16 hi/lo pair laid out as wgmma's A fragment: keys
// [16kk, 16kk + 16) are p[8kk .. 8kk + 8).
template <int kBN>
__device__ __forceinline__ void split_p(const float (&p)[kBN / 2],
                                        uint32_t (&p_hi)[kBN / 16][4],
                                        uint32_t (&p_lo)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float p0 = p[8 * kk + 2 * a], p1 = p[8 * kk + 2 * a + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[kk][a] = bf16x2_bits(hi);
      p_lo[kk][a] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
    }
}

template <int kD>
__device__ __forceinline__ void rescale(float (&acc)[kD / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      acc[4 * n + 2 * r] *= corr[r];
      acc[4 * n + 2 * r + 1] *= corr[r];
    }
}

// The work item a block takes on its pass-th round: heaviest items first,
// dealt in snake order (0..G-1, then G-1..0, ...) so each block's total
// work evens out without a shared counter.
__device__ __forceinline__ int work_item(int pass) {
  const int g = gridDim.x;
  return pass * g + ((pass & 1) ? g - 1 - blockIdx.x : blockIdx.x);
}

template <int kD, int kBN>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, int sq, int sk, int h, int hkv,
               int d, int causal, int window, float scale, int n_qt,
               int n_work) {
  using C = Cfg<kD, kBN>;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;                       // 2 halves x kChunks x 8 KB
  const uint32_t s_k = s_q + 2 * C::kQHalf;        // kStages tiles
  const uint32_t s_v = s_k + kStages * C::kTile;   // kStages tiles
  const uint32_t full = s_v + kStages * C::kTile;  // full[kStages]
  const uint32_t empty = full + 8 * kStages;       // empty[kStages]
  const uint32_t q_full = empty + 8 * kStages;
  const uint32_t q_empty = q_full + 8;
  const int wg = threadIdx.x / 128;
  const int heads_b = n_work / n_qt;               // heads x batch

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 8);   // one arrival a consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Work item j is query tile n_qt - 1 - j / heads_b of (head, batch)
  // j % heads_b: the heaviest tiles (most keys under the causal mask) come
  // first (work_item).
  if (wg == 2) {
    // producer: one thread loads each work item's Q once Q is free, and
    // keeps the K/V ring full across work items
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int g = 0;   // ring position, counted across work items
      for (int u = 0, j = work_item(0); j < n_work; j = work_item(++u)) {
        const int q0 = (n_qt - 1 - j / heads_b) * kBlockQ;
        const int head = j % heads_b % h, b = j % heads_b / h;
        const int khead = head / (h / hkv);
        int kt_begin, kt_end;
        key_tiles(q0, min(q0 + kBlockQ, sq) - 1, sk, causal, window, kBN,
                  &kt_begin, &kt_end);
        if (u > 0) mbar_wait(q_empty, (u - 1) & 1);  // last item read Q
        mbar_expect_tx(q_full, 2 * C::kQHalf);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c)
            tma_load_4d(s_q + half * C::kQHalf + c * 8192u, &tq, q_full,
                        64 * c, head, q0 + 64 * half, b);
        for (int kt = kt_begin; kt < kt_end; ++kt, ++g) {
          const int st = g % kStages;
          mbar_wait(empty + 8 * st, ((g / kStages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * st, 2 * C::kTile);
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c) {
            tma_load_4d(s_k + st * C::kTile + c * C::kChunkRows, &tk,
                        full + 8 * st, 64 * c, khead, kt * kBN, b);
            tma_load_4d(s_v + st * C::kTile + c * C::kChunkRows, &tv,
                        full + 8 * st, 64 * c, khead, kt * kBN, b);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [wq0, wq0 + 64) of a work
  // item.  The two warpgroups take turns issuing S = Q K^T, so one's
  // softmax runs while the other's products do.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  float s[kBN / 2];
  uint32_t p_hi[kBN / 16][4], p_lo[kBN / 16][4];
  if (wg == 1) turn_pass(wg);   // warpgroup 0 takes the first turn
  int g = 0;
  for (int u = 0, j = work_item(0); j < n_work; j = work_item(++u)) {
    const int q0 = (n_qt - 1 - j / heads_b) * kBlockQ;
    const int head = j % heads_b % h, b = j % heads_b / h;
    int kt_begin, kt_end;
    key_tiles(q0, min(q0 + kBlockQ, sq) - 1, sk, causal, window, kBN,
              &kt_begin, &kt_end);
    Rows w;
    w.wq0 = q0 + 64 * wg;
    w.wq_last = min(w.wq0 + 64, sq) - 1;
    w.row0 = w.wq0 + 16 * (t / 32) + lane / 4;
    w.col0 = 2 * (lane % 4);
    float acc[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};
    float corr[2];

    const uint32_t q_half = s_q + wg * C::kQHalf;
    mbar_wait(q_full, u & 1);
    if (kt_begin == kt_end) {
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);
    }
    for (int kt = kt_begin; kt < kt_end; ++kt, ++g) {
      const int st = g % kStages;
      mbar_wait(full + 8 * st, (g / kStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      issue_s<kD, kBN>(s, q_half, s_k + st * C::kTile);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      turn_pass(wg);
      if (kt + 1 == kt_end) {   // the work item's last read of Q
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty);
      }
      softmax_tile<kBN>(s, m, l, corr, w, kt * kBN, sk, causal, window,
                        scale);
      rescale<kD>(acc, corr);
      split_p<kBN>(s, p_hi, p_lo);
      wgmma_fence();
      issue_pv<kD, kBN>(acc, p_hi, p_lo, s_v + st * C::kTile);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);   // the stage is free
    }

    const float inv[2] = {1.0f / fmaxf(l[0], 1e-20f),
                          1.0f / fmaxf(l[1], 1e-20f)};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = w.row0 + 8 * r;
      if (qpos >= sq) continue;
      __nv_bfloat16* out =
          o + ((static_cast<long>(b) * sq + qpos) * h + head) * d;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const int col = 8 * n + w.col0;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv[r],
                                    acc[4 * n + 2 * r + 1] * inv[r]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the CUDA runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (b, s, heads, d) bf16 tensor as a 4-D map read in boxes of 64 columns
// of d by `rows` positions of one (batch, head), 128-byte swizzled; reads
// past d or s are filled with zeros.
CUresult make_map(CUtensorMap* map, const void* ptr, int b, int s, int heads,
                  int d, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t row = 2ull * d;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * s};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int kD, int kBN>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq,
           int sk, int h, int hkv, int d, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = Cfg<kD, kBN>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16<kD, kBN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  CUresult res = make_map(&tq, q, b, sq, h, d, 64);
  if (res == CUDA_SUCCESS) res = make_map(&tk, k, b, sk, hkv, d, kBN);
  if (res == CUDA_SUCCESS) res = make_map(&tv, v, b, sk, hkv, d, kBN);
  if (res != CUDA_SUCCESS) return kTensorMapErrorBase + static_cast<int>(res);
  // one block an SM walks the (query tile, head, batch) work items
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + kBlockQ - 1) / kBlockQ;
  const int n_work = n_qt * h * b;
  const int grid = n_work < sms ? n_work : sms;
  flash_bf16<kD, kBN><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sq, sk, h, hkv, d, causal,
      window, scale, n_qt, n_work);
  return cudaGetLastError();
}

size_t smem_for(int d) {
  if (d <= 64) return Cfg<64, 128>::kSmem;
  if (d <= 128) return Cfg<128, 128>::kSmem;
  if (d <= 192) return Cfg<192, 64>::kSmem;
  return Cfg<256, 64>::kSmem;
}

int by_width(const void* q, const void* k, const void* v, void* o, int b,
             int sq, int sk, int h, int hkv, int d, int causal, int window,
             float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch<64, 128>(q, k, v, o, b, sq, sk, h, hkv, d, causal,
                               window, scale, stream);
  if (d <= 128)
    return launch<128, 128>(q, k, v, o, b, sq, sk, h, hkv, d, causal, window,
                            scale, stream);
  if (d <= 192)
    return launch<192, 64>(q, k, v, o, b, sq, sk, h, hkv, d, causal, window,
                           scale, stream);
  return launch<256, 64>(q, k, v, o, b, sq, sk, h, hkv, d, causal, window,
                         scale, stream);
}

}  // namespace bf16

}  // namespace

extern "C" {

// Dynamic shared memory one block of the design for `dtype` needs at head
// width d.
size_t flash_smem_bytes(int dtype, int d) {
  return dtype == kBF16 ? bf16::smem_for(d) : f32::smem_for(d);
}

const char* flash_error_string(int err) {
  if (err >= kTensorMapErrorBase)
    return "cuTensorMapEncodeTiled failed to encode a TMA tensor map (code - "
           "100000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// o (b, sq, h, d) = attention of q (b, sq, h, d) over k/v (b, sk, hkv, d),
// all contiguous and of one type (0 fp32, 1 bf16); d a multiple of 16 up to
// 256; window <= 0 means no window; the scores times scale, 0 for
// 1 / sqrt(d).
int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                        void* o, int b, int sq, int sk, int h, int hkv, int d,
                        int causal, int window, float scale, void* stream) {
  if (d <= 0 || d > 256 || d % 16 != 0 || hkv <= 0 || h % hkv != 0)
    return cudaErrorInvalidValue;
  if (!(scale > 0.0f)) scale = 1.0f / sqrtf(static_cast<float>(d));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return f32::by_width(q, k, v, o, b, sq, sk, h, hkv, d, causal, window,
                           scale, s);
    case kBF16:
      return bf16::by_width(q, k, v, o, b, sq, sk, h, hkv, d, causal, window,
                            scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
