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
// (B,nh,nc,q) fp32.  The chunk length q is any value up to 256, hd any value
// up to 256, ds a multiple of 4 up to 256.
//
// What bounds it on an H100: inside a chunk SSD is causal attention with a
// decay in place of the softmax (C the queries, B the keys, x the values).
// The function needs 2*ds flops for each causal pair j <= i of a B/C group
// (C.B^T is shared by the group's heads), 2*hd for each pair of a head, and
// 2*q*ds*hd for a head's chunk state; it moves x, dt, B and C in and y, st
// and cum out once.  At hymba-1.5b's widths (q 256, hd 64, ds 16, 50 heads
// in one group) that is bound by operations: about 15.2 GFLOP for the
// serving path's widest wave (B 4, S 4096), 0.23 ms at the 67 TFLOP/s of
// fp32 FMAs.  All math is exact fp32 FMAs (no TF32), whatever the input
// type, so the FMA pipes and the instructions that feed them are the limit.
//
// What this design does about it (the fp32 flash design of
// flash_attention.cu, with the decay in place of the online softmax):
// - Work items of 64 output rows of one (b, h, chunk), one block of 4 warps
//   each, one block an item; the grid is ordered by the rank of the row
//   tile, last tile first, so the items with the most key tiles start
//   first.  Each item runs the chunk's cum scan itself with the same code
//   in the same order, so every item sees the same bits; the item of the
//   last row tile writes cum.
// - Register micro-tiles: a warp owns a band of 16 rows of the item (the
//   bands rotate with the block, so the warp with the most keys on the
//   diagonal is not always on the same scheduler), lane (tr, tc) rows
//   tr + 4i (i < 4) and keys tc + 8jj of each key tile.  G = C_i B_j^T is a
//   4 x 8 micro-tile over depth ds (4 + 8 vector loads feed 128 FMAs);
//   M = G exp(cum_i - cum_j) dt_j is formed in registers, with one exp a
//   pair (never exp(cum_i) exp(-cum_j), which overflows), and masked only
//   on the tile that crosses the diagonal or the chunk's end.  M goes
//   through a shared strip that only its own warp reads back, and O is a
//   4 x hd/8 micro-tile: per 4 keys, 4 vector loads of M and hd/16 of x feed
//   hd/2 FMAs.  On the diagonal a warp computes and multiplies only the keys
//   its own 16 rows can see.
// - A two-slot cp.async ring streams (B_j, x_j) in 16-byte copies while
//   the previous tile computes; C_i is staged once, in the input type.
//   bf16 tiles land as bf16 and are widened to fp32 once a tile (not once
//   a warp that reads them).  A row whose bytes are not a multiple of 16
//   (or a base pointer that is not 16-byte aligned) is staged element by
//   element instead.  Key tiles are 64 wide where three blocks an SM fit in
//   shared memory (71,680 B at hymba-1.5b's widths), else 32.
// - The chunk state rides on the y pass: the item of the last row tile
//   visits every key tile, and while B_j and x_j sit in shared memory it
//   adds B_j^T (w_j x_j) into a register tile, w_j = exp(total - cum_j) dt_j
//   once a row, over the ds rows that exist, spread over all 128 threads.
//   Where ds * hd is too large for one pass of registers, extra items
//   (ordered last) add the remaining rows of the state the same way.
// - D x comes from the staged x of the diagonal tile.
// What holds it back: registers.  ptxas caps a thread at 168 for 3 blocks
// an SM (12 warps) and uses them all; at the 128 of 4 blocks it spills.
// With 12 warps the kernel stays about 4x above its operations bound on an
// H100: the stalls of the LDS-fed loops and the barriers between tiles.
// Not the loads from device memory: a persistent variant, whose next tiles
// had always landed when it waited for them, ran no faster.  Not the count
// of instructions either: most of a whole tile's are FMAs.
// No atomics: every output element has one owner, so a launch's result does
// not depend on timing.
//
// C interface for ctypes: every pointer and the stream are void*, and the
// entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                  // output rows of an item
constexpr int kMaxChunk = 256;
constexpr float kLog2e = 1.4426950408889634f;
// dynamic shared memory of a block when 3 share an SM's 228 KB, each with
// 1 KB reserved
constexpr size_t kSmemFor3 = 228 * 1024 / 3 - 1024;

enum ElemType { kF32 = 0, kBF16 = 1 };

// 2^x on the special-function unit (2 ulp); very negative x gives 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// four consecutive elements (16- or 8-byte aligned), widened to fp32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// kN consecutive floats of a state row's B into out[0 .. kN)
template <int kN>
__device__ __forceinline__ void ldn(const float* p, float* out) {
  if constexpr (kN == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    const float4 v = ld4(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// Row stride of a staged tile, in elements: the width rounded up to 16
// bytes, plus 16 bytes, so rows start 16-byte aligned and rows 8 apart
// start in distinct bank groups.
template <typename T>
__host__ __device__ __forceinline__ int row_stride(int width) {
  constexpr int e = 16 / sizeof(T);
  return (width + e - 1) / e * e + e;
}

// Row stride of the M strip, in floats: rows 1 apart start 8 banks apart.
__host__ __device__ constexpr int p_stride(int keys) { return keys + 8; }

// Shared memory, in floats from the base: cum, dt and w (256 each); C_i in
// the input type; the ring of two (B_j, x_j) slots in the input type; bf16's
// widened (B_j, x_j); the M strip last, so that the x tiles' over-read past
// hd stays inside the allocation.
template <typename T>
struct Layout {
  int c, ring, work, p, total;
  __host__ __device__ Layout(int hd, int ds, int keys) {
    constexpr int per = sizeof(float) / sizeof(T);  // T a float holds
    const bool widen = per > 1;
    c = 3 * kMaxChunk;
    ring = c + kRows * row_stride<T>(ds) / per;
    work = ring + 2 * keys * (row_stride<T>(ds) + row_stride<T>(hd)) / per;
    p = work + (widen ? keys * (row_stride<float>(ds) +
                                row_stride<float>(hd)) : 0);
    total = p + kRows * p_stride(keys);
  }
};

template <typename T>
size_t smem_bytes(int hd, int ds, int keys) {
  return sizeof(float) * static_cast<size_t>(Layout<T>(hd, ds, keys).total);
}

struct Dims {
  int b, s, nh, hd, g, ds, q, nc, rep;
  int vec_x, vec_bc;  // 1: rows go by 16-byte cp.async copies
  int st_cols;        // threads across a state row (a power of 2 >= hd/4)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

// Calls f(r, c) for each copy (r < nrows, c < per_row) of a tile that falls
// to this thread: it starts at copy threadIdx.x and steps kThreads copies,
// dr rows and dc copies, at a time.  Two divisions a tile, none a copy.
template <typename F>
__device__ __forceinline__ void walk(int per_row, int nrows, F f) {
  const int dr = kThreads / per_row, dc = kThreads - dr * per_row;
  int r = threadIdx.x / per_row;
  for (int cc = threadIdx.x - r * per_row; r < nrows; r += dr, cc += dc) {
    if (cc >= per_row) {
      cc -= per_row;
      ++r;
      if (r >= nrows) break;
    }
    f(r, cc);
  }
}

// Stage rows [t0, t0 + nrows) of the chunk from the (b, head) slice of a
// (B,S,heads,width) tensor into a (nrows, stride) tile of T; rows at or past
// q are zero.  vec: 16-byte cp.async copies (queued, not waited for), else
// element by element.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      long row_base, int heads, int head,
                                      int width, int stride, int t0,
                                      int nrows, int q, int vec) {
  if (vec) {
    constexpr int e = 16 / sizeof(T);
    walk(width / e, nrows, [&](int r, int cc) {
      const int t = t0 + r;
      const T* g = src + ((row_base + min(t, q - 1)) * heads + head) * width +
                   cc * e;
      cp_async16(dst + r * stride + cc * e, g, t < q ? 16 : 0);
    });
  } else {
    walk(width, nrows, [&](int r, int cc) {
      const int t = t0 + r;
      T v;
      store(&v, 0.0f);
      if (t < q) v = src[((row_base + t) * heads + head) * width + cc];
      dst[r * stride + cc] = v;
    });
  }
}

// Widen an (nrows, width) bf16 tile of row stride ss into fp32 of row
// stride sf, four elements a copy (into the rows' padding past width).
__device__ __forceinline__ void widen(float* dst, int sf,
                                      const __nv_bfloat16* src, int ss,
                                      int nrows, int width) {
  walk((width + 3) / 4, nrows, [&](int r, int c4) {
    *reinterpret_cast<float4*>(dst + r * sf + 4 * c4) =
        ld4(src + r * ss + 4 * c4);
  });
}

// kMinBlocks: blocks an SM that the registers must allow (shared memory
// allows 3 at hymba's widths); kStRows: consecutive state rows a
// thread owns in one pass (2 at hd <= 64 keeps hymba's 16 x 64 state on all
// 128 threads, and the registers under the cap)
template <int kMaxHd>
struct Cfg {
  static constexpr int kMinBlocks = kMaxHd <= 64 ? 3 : kMaxHd <= 128 ? 2 : 1;
  static constexpr int kStRows = kMaxHd <= 64 ? 2 : 4;
};

template <typename T, int kMaxHd, int kKeys>
__global__ void __launch_bounds__(kThreads, Cfg<kMaxHd>::kMinBlocks)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const float* __restrict__ Dv,
                     Dims dims, T* __restrict__ y, float* __restrict__ st,
                     float* __restrict__ cum_out) {
  constexpr int kKpt = kKeys / 8;     // keys of a tile a lane owns in G
  constexpr int kCol4 = kMaxHd / 32;  // 4-column groups of O a lane owns
  constexpr int ps = p_stride(kKeys);
  constexpr int kStRows = Cfg<kMaxHd>::kStRows;
  constexpr bool kWiden = sizeof(T) == 2;  // bf16 lands, then widens
  extern __shared__ float4 smem4[];
  __shared__ float s_warp[kWarps];
  const int q = dims.q, hd = dims.hd, ds = dims.ds, nc = dims.nc;
  const int sc = row_stride<T>(ds), sx = row_stride<T>(hd);  // landed
  const int scf = row_stride<float>(ds), sxf = row_stride<float>(hd);
  const Layout<T> lay(hd, ds, kKeys);
  float* base = reinterpret_cast<float*>(smem4);
  float* s_cum = base;                            // (256)
  float* s_dt = s_cum + kMaxChunk;                // (256)
  float* s_w = s_dt + kMaxChunk;                  // (256) state weights
  T* s_c = reinterpret_cast<T*>(base + lay.c);    // (64, sc)
  // ring slot k: B at s_ring + k * slot (kKeys, sc), then x (kKeys, sx);
  // slots are offsets from the shared base, never pointers kept in an
  // array, so every tile read stays a shared-memory load
  T* s_ring = reinterpret_cast<T*>(base + lay.ring);
  const int slot = kKeys * (sc + sx);
  float* s_work = base + lay.work;                // bf16: (B, x) widened
  float* s_p = base + lay.p;                      // (64, ps) the M strip

  // ---- which item: rank 0 is every chunk's last row tile (the heaviest,
  // which also adds the state), then the tiles above it, then the extra
  // state passes ----
  const int units = dims.b * dims.nh * nc;
  const int rank = blockIdx.x / units;
  const int unit = blockIdx.x - rank * units;
  const int c = unit % nc;
  const int h = (unit / nc) % dims.nh;
  const int b = unit / (nc * dims.nh);
  const int ntiles = (q + kRows - 1) / kRows;
  const bool do_y = rank < ntiles;
  const int it = do_y ? ntiles - 1 - rank : ntiles - 1;
  const bool do_state = it == ntiles - 1;
  const int pass = do_y ? 0 : rank - ntiles + 1;
  const int i0 = it * kRows;
  const int nkt = (min(i0 + kRows, q) + kKeys - 1) / kKeys;
  const int grp = h / dims.rep;
  const long row_base = static_cast<long>(b) * dims.s + static_cast<long>(c) * q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // ring: group {C_i, tile 0}, then group {tile 1}
  auto stage_tile = [&](int t, int k) {
    T* dst = s_ring + k * slot;
    stage(dst, Bm, row_base, dims.g, grp, ds, sc, t * kKeys, kKeys, q,
          dims.vec_bc);
    stage(dst + kKeys * sc, x, row_base, dims.nh, h, hd, sx, t * kKeys, kKeys,
          q, dims.vec_x);
  };
  if (do_y)
    stage(s_c, Cm, row_base, dims.g, grp, ds, sc, i0, kRows, q, dims.vec_bc);
  stage_tile(0, 0);
  cp_async_commit();
  if (nkt > 1) stage_tile(1, 1);
  cp_async_commit();

  // cum = inclusive scan of dt * A over the chunk, positions 2t and 2t + 1
  // a thread; the same code in every item, so the same bits
  {
    const float a = A[h];
    const int p0 = 2 * tid, p1 = 2 * tid + 1;
    const float d0 = p0 < q ? dt[(row_base + p0) * dims.nh + h] : 0.0f;
    const float d1 = p1 < q ? dt[(row_base + p1) * dims.nh + h] : 0.0f;
    const float v0 = d0 * a;
    const float v1 = v0 + d1 * a;
    float incl = v1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += n;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    float pre = 0.0f;
    for (int w = 0; w < warp; ++w) pre += s_warp[w];
    pre += excl;
    const float c0 = pre + v0, c1 = pre + v1;
    const bool writer = do_y && do_state;
    float* co = cum_out + ((static_cast<long>(b) * dims.nh + h) * nc + c) * q;
    if (p0 < q) {
      s_cum[p0] = c0;
      s_dt[p0] = d0;
      if (writer) co[p0] = c0;
    }
    if (p1 < q) {
      s_cum[p1] = c1;
      s_dt[p1] = d1;
      if (writer) co[p1] = c1;
    }
  }
  __syncthreads();
  if (do_state) {
    const float total = s_cum[q - 1];
    for (int t = tid; t < kMaxChunk; t += kThreads)
      s_w[t] = t < q ? expf(total - s_cum[t]) * s_dt[t] : 0.0f;
  }  // visible after the loop's first barrier

  // y: lane (tr, tc) of a warp owns rows r0 + tr + 4i of the warp's band
  // of 16.  The bands rotate with the block, so the warp with the most
  // keys on the diagonal sits on another scheduler in each block.
  const int tr = lane / 8, tc = lane % 8;
  const int wrow = ((warp + blockIdx.x) % kWarps) * 16;  // band's first row
  const int r0 = i0 + wrow;                               // ... in the chunk
  const int w_end = min(r0 + 16, q);
  float cum_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) cum_i[i] = s_cum[min(r0 + tr + 4 * i, q - 1)];
  float4 acc[4][kCol4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCol4; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float dh = Dv[h];

  // state: thread (srow, scol) owns rows n0 .. n0 + kStRows - 1 and
  // columns 4 scol .. 4 scol + 3
  const int hd4 = (hd + 3) / 4;
  const int R = kThreads / dims.st_cols;
  const int scol = tid % dims.st_cols, srow = tid / dims.st_cols;
  const int n0 = (pass * R + srow) * kStRows;
  float4 sacc[kStRows];
#pragma unroll
  for (int k = 0; k < kStRows; ++k) sacc[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * kKeys;
    const T* landed = s_ring + (t & 1) * slot;
    cp_async_wait_1();  // tile t has landed; tile t + 1 may be in flight
    __syncthreads();
    const float* sb = reinterpret_cast<const float*>(landed);
    if constexpr (kWiden) {  // once a tile, not once a warp that reads it
      const __nv_bfloat16* lb = reinterpret_cast<const __nv_bfloat16*>(landed);
      widen(s_work, scf, lb, sc, kKeys, ds);
      widen(s_work + kKeys * scf, sxf, lb + kKeys * sc, sx, kKeys, hd);
      __syncthreads();  // the slot is free: tile t + 2 starts now
      if (t + 2 < nkt) stage_tile(t + 2, t & 1);
      cp_async_commit();
      sb = s_work;
    }
    const float* sxt = sb + kKeys * scf;
    const int nk = min(w_end - k0, kKeys);  // keys the warp's rows see
    if (do_y && r0 < q && nk > 0) {
      const int jmax = (nk + 7) / 8;
      float gacc[4][kKpt];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < kKpt; ++jj) gacc[i][jj] = 0.0f;
      // G over depth ds; a whole tile runs without the per-key predicate
      auto gram = [&](auto whole) {
#pragma unroll 2
        for (int n = 0; n < ds; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = ld4(s_c + (wrow + tr + 4 * i) * sc + n);
#pragma unroll
          for (int jj = 0; jj < kKpt; ++jj) {
            if (decltype(whole)::value || jj < jmax) {
              const float4 bv = ld4(sb + (tc + 8 * jj) * scf + n);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                float g = gacc[i][jj];
                g = fmaf(cv[i].x, bv.x, g);
                g = fmaf(cv[i].y, bv.y, g);
                g = fmaf(cv[i].z, bv.z, g);
                g = fmaf(cv[i].w, bv.w, g);
                gacc[i][jj] = g;
              }
            }
          }
        }
      };
      if (jmax == kKpt)
        gram(std::true_type{});
      else
        gram(std::false_type{});
      // M = G exp(cum_i - cum_j) dt_j; masked where a key lies above a row
      // or past the chunk, which only the tile that crosses them has
      const bool edge = k0 + kKeys - 1 > r0 || k0 + kKeys > q;
#pragma unroll
      for (int jj = 0; jj < kKpt; ++jj) {
        if (jj < jmax) {
          const int jl = tc + 8 * jj;
          const int jg = k0 + jl;
          const float cj = s_cum[min(jg, q - 1)];
          const float dj = s_dt[min(jg, q - 1)];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ig = r0 + tr + 4 * i;
            const bool keep = !edge || (jg <= ig && jg < q);
            const float mv =
                keep ? gacc[i][jj] * (ex2((cum_i[i] - cj) * kLog2e) * dj)
                     : 0.0f;
            s_p[(wrow + tr + 4 * i) * ps + jl] = mv;
          }
        }
      }
      __syncwarp();
      // O += M x_j, four keys at a time; a row's M is a broadcast from
      // the strip its own warp wrote.  Columns at or past hd (when hd <
      // kMaxHd) read the next row or region of shared memory, inside the
      // allocation, into accumulators that are never stored: no branch.
      const int nk4 = (nk + 3) & ~3;
#pragma unroll 2
      for (int j4 = 0; j4 < nk4; j4 += 4) {
        float4 p4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p4[i] = *reinterpret_cast<const float4*>(
              s_p + (wrow + tr + 4 * i) * ps + j4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* xrow = sxt + (j4 + e) * sxf;
#pragma unroll
          for (int j = 0; j < kCol4; ++j) {
            const float4 xv = ld4(xrow + 4 * (tc + 8 * j));
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float mv = e == 0 ? p4[i].x : e == 1 ? p4[i].y
                             : e == 2 ? p4[i].z : p4[i].w;
              fma4(acc[i][j], mv, xv);
            }
          }
        }
      }
      // D x from the staged x, on the tile that holds the row's own key
      // (its last tile, so y = sum + D x in the reference's order)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ig = r0 + tr + 4 * i;
        if (ig >= k0 && ig < k0 + kKeys) {
          const float* xrow = sxt + (ig - k0) * sxf;
#pragma unroll
          for (int j = 0; j < kCol4; ++j)
            fma4(acc[i][j], dh, ld4(xrow + 4 * (tc + 8 * j)));
        }
      }
      __syncwarp();  // the strip is read before the next tile rewrites it
    }

    // st += B_j^T (w_j x_j) over the keys of this tile, four at a time
    // (B, x and w are 0 past the chunk)
    if (do_state && scol < hd4 && n0 < ds) {
      const int kend = min(kKeys, q - k0);
      for (int jl = 0; jl < kend; jl += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(s_w + k0 + jl);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float we = e == 0 ? w4.x : e == 1 ? w4.y
                         : e == 2 ? w4.z : w4.w;
          const float4 xv = ld4(sxt + (jl + e) * sxf + 4 * scol);
          float bn[kStRows];
          ldn<kStRows>(sb + (jl + e) * scf + n0, bn);
#pragma unroll
          for (int kk = 0; kk < kStRows; ++kk) fma4(sacc[kk], bn[kk] * we, xv);
        }
      }
    }

    if constexpr (!kWiden) {
      __syncthreads();  // every warp is done with this slot
      if (t + 2 < nkt) stage_tile(t + 2, t & 1);
      cp_async_commit();
    }
    // (bf16: the next tile's first barrier comes before s_work is rewritten)
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  if (do_y) {
    const bool vec_out = hd % 4 == 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ig = r0 + tr + 4 * i;
      if (ig >= q) continue;
      T* out = y + ((row_base + ig) * dims.nh + h) * hd;
#pragma unroll
      for (int j = 0; j < kCol4; ++j) {
        const int col = 4 * (tc + 8 * j);
        if (col >= hd) continue;
        const float4 v = acc[i][j];
        if (vec_out) {
          store4(out + col, v);
        } else {
          const float vs[4] = {v.x, v.y, v.z, v.w};
          for (int e = 0; e < 4 && col + e < hd; ++e)
            store(out + col + e, vs[e]);
        }
      }
    }
  }
  if (do_state && scol < hd4 && n0 < ds) {
    float* so = st + ((static_cast<long>(b) * dims.nh + h) * nc + c) *
                         static_cast<long>(ds) * hd;
    const int col = 4 * scol;
#pragma unroll
    for (int kk = 0; kk < kStRows; ++kk) {
      float* row = so + static_cast<long>(n0 + kk) * hd;
      if (hd % 4 == 0) {
        store4(row + col, sacc[kk]);
      } else {
        const float vs[4] = {sacc[kk].x, sacc[kk].y, sacc[kk].z, sacc[kk].w};
        for (int e = 0; e < 4 && col + e < hd; ++e) row[col + e] = vs[e];
      }
    }
  }
}


// Work items of a launch: row tiles a chunk, plus the chunk's extra state
// passes (rows of ds that one pass of the 128 threads holds in registers).
template <int kMaxHd>
int items_for(const Dims& d) {
  const int ntiles = (d.q + kRows - 1) / kRows;
  const int pass_rows = kThreads / d.st_cols * Cfg<kMaxHd>::kStRows;
  const int passes = (d.ds + pass_rows - 1) / pass_rows;
  return d.b * d.nh * d.nc * (ntiles + passes - 1);
}

template <typename T, int kMaxHd, int kKeys>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* Dv, const Dims& dims, void* y,
                   void* st, void* cum, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(dims.hd, dims.ds, kKeys);
  auto kernel = ssd_chunk_kernel<T, kMaxHd, kKeys>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // one block an item, in rank order: the hardware deals the heaviest out
  // first, and the rest as blocks finish
  kernel<<<items_for<kMaxHd>(dims), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(Dv), dims,
      static_cast<T*>(y), static_cast<float*>(st), static_cast<float*>(cum));
  return cudaGetLastError();
}

// 64-key tiles where 3 blocks an SM still fit in shared memory, else 32
template <typename T>
int keys_for(int hd, int ds) {
  return hd <= 128 && smem_bytes<T>(hd, ds, 64) <= kSmemFor3 ? 64 : 32;
}

template <typename T>
size_t smem_for(int hd, int ds) {
  return smem_bytes<T>(hd, ds, keys_for<T>(hd, ds));
}

template <typename T>
cudaError_t by_width(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, const void* Dv,
                     const Dims& dims, void* y, void* st, void* cum,
                     cudaStream_t stream) {
  const bool wide = keys_for<T>(dims.hd, dims.ds) == 32;
  if (dims.hd <= 64)
    return wide ? launch<T, 64, 32>(x, dt, A, Bm, Cm, Dv, dims, y, st, cum,
                                    stream)
                : launch<T, 64, 64>(x, dt, A, Bm, Cm, Dv, dims, y, st, cum,
                                    stream);
  if (dims.hd <= 128)
    return wide ? launch<T, 128, 32>(x, dt, A, Bm, Cm, Dv, dims, y, st, cum,
                                     stream)
                : launch<T, 128, 64>(x, dt, A, Bm, Cm, Dv, dims, y, st, cum,
                                     stream);
  return launch<T, 256, 32>(x, dt, A, Bm, Cm, Dv, dims, y, st, cum, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for inputs of type dtype (0 fp32,
// 1 bf16) at head width hd and state width ds.
size_t ssd_smem_bytes(int dtype, int hd, int ds) {
  return dtype == kBF16 ? smem_for<__nv_bfloat16>(hd, ds)
                        : smem_for<float>(hd, ds);
}

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
      ds <= 0 || ds > 256 || ds % 4 != 0 || g <= 0 || nh % g != 0 ||
      (dtype != kF32 && dtype != kBF16))
    return cudaErrorInvalidValue;
  const int esize = dtype == kBF16 ? 2 : 4;
  int st_cols = 1;
  while (st_cols < (hd + 3) / 4) st_cols *= 2;
  const Dims dims{b, s, nh, hd, g, ds, q, s / q, nh / g,
                  (hd * esize) % 16 == 0 && aligned16(x),
                  (ds * esize) % 16 == 0 && aligned16(Bm) && aligned16(Cm),
                  st_cols};
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return by_width<float>(x, dt, A, Bm, Cm, Dv, dims, y, st, cum, st_);
  return by_width<__nv_bfloat16>(x, dt, A, Bm, Cm, Dv, dims, y, st, cum, st_);
}

}  // extern "C"
