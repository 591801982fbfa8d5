// k-means assignment and fused assign+update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/kmeans.py: the body
// _make_kernel (:80) behind pl.pallas_call (:196), reached through
// kmeans_assign_update (:222, fused) and kmeans_assign (:213, assign only).
//
// What it computes, per point row x against K centroids c (F features):
//   d2[k] = max(|x|^2 - 2 x.c_k + |c_k|^2, 0)   (the expansion, not
//                                                sum (x-c)^2, so ids and the
//                                                dmin floor near d = 0 round
//                                                like the reference)
//   id    = first k with the smallest d2           (strict <, as jnp.argmin)
//   dmin  = sqrt(d2[id])
// and, in the fused form, the per-centroid sums (K,F) and counts (K) of the
// rows assigned to each centroid.  Points are fp32, bf16 bits, or int8 with
// per-feature scales (widened as v * scale); every product and sum is fp32.
//
// What bounds it on an H100: it reads the points once, N*F*{4,2,1} bytes for
// fp32/bf16/int8, and writes 8N bytes of ids and distances; it does 2*N*K*F
// flops of dot products, N*K*F FMAs on the fp32 pipes (the per-feature int8
// scales do not factor out of a product).  At the paper's K = 25, F = 32 that
// is 0.041 ms of bytes and 0.024 ms of FMAs at 1M fp32 rows.
//
// What the design does about it:
// * Persistent tiles.  A tile is kRows contiguous rows (64, 128 or 256; 128
//   by default) and a block has kRows / 2 threads (kRows / 64 warps); the
//   grid is min(tiles, SMs x resident blocks) and block b walks tiles b,
//   b + grid, ... in order.  Each block stages the centroids, |c|^2 and the
//   scales once.
// * Asynchronous staging.  A tile is one flat byte range of the points in
//   their storage type; 16-byte cp.async copies bring tile t+1 into the
//   second slot of a two-slot ring while tile t computes (one slot where two
//   do not fit).  Bytes before the first 16-byte aligned address and after
//   the last are copied with plain loads, so any start address is taken.
//   Where every row starts on a 16-byte boundary, the 16-byte chunks of each
//   128-byte line are swizzled as they land, so a warp's row reads spread
//   over all banks.
// * Rows in registers, centroids as broadcasts.  A thread owns two rows
//   (t and t + 64 of the tile).  It widens 32 features of each at a time from
//   shared memory into registers and keeps 2 x 32 dot products in registers,
//   one chunk of 32 centroids at a time.
//   Centroids lie in shared memory zero-padded to multiples of 32 in K and F
//   (|c|^2 padded with +inf, so a padded centroid never wins a strict <) and
//   are read as float4 loads at one address for the whole warp: 8 FMAs a
//   shared load, where a row-per-thread loop over shared rows and centroids
//   issues two loads an FMA.  A float4 load still delivers 512 bytes to the
//   warp's registers, four clocks of the SM's 128 bytes a clock of shared
//   memory, against eight clocks of the warp's FMAs on one of the SM's four
//   schedulers: two rows a thread halve that delivery against one row.
// * Fused sums in rows x F work.  After a tile's assignment the ids go to
//   shared memory; warp w owns the tile's rows 64w .. 64w+63 and an
//   accumulator copy (Kp x Fp sums and Kp counts).  Lane l owns feature
//   columns l, l+32, ...; the warp walks its rows in order and adds x[r][j]
//   into acc[id_r][j], a read-modify-write no other lane touches: no
//   atomics.  It takes the rows 8 at a time, loading the 8 accumulators
//   before storing any; a row whose id an earlier row of the 8 shares adds
//   onto that row's new value, so the bits are those of one read-modify-write
//   after another, without a shared-memory round trip between them.  Where
//   fewer copies fit than there are warps, the warps that share a copy take
//   turns in warp order.  When its tiles are done the block adds its copies
//   in warp order and writes one partial; a second launch adds the <= grid
//   partials in block order, one thread per output element.
//
// The order of every sum is fixed:
//   |x|^2 and x.c_k: fmaf over the features in ascending order (as the
//     kernel's first version did, so ids and dmin are that version's bits);
//   sums and counts: within a copy, tiles in the block's order, within a tile
//     the warps that share the copy in warp order, within a warp its rows in
//     order; then the block's copies in warp order; then the partials in
//     block order.
// So the fused outputs are the same bits on every launch on the same card;
// their last bits depend on the grid, which follows the card's SM count and
// the tile.  ids and dmin are one thread's sums over one row, so they are the
// same bits in every tile instance.
//
// The tile is a template parameter.  The library holds its three instances
// (64, 128 and 256 rows, each for the three point types and both forms), and
// every entry point takes the tile as an argument (kernels/kmeans.py,
// autotune_block_n).
//
// C interface for ctypes: every pointer and the stream are void*, and each
// entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRowsPerThread = 2;      // rows a thread holds in registers
constexpr int kBatch = 8;              // rows of one batch of the sums' adds
constexpr int kChunk = 32;             // features / centroids a register chunk
constexpr size_t kMaxSmem = 232448;    // dynamic shared memory, sm_90 block

// Threads and warps of a block whose tile is kRows rows.  Every warp adds
// 64 rows of a tile to the sums, two ids a lane.
template <int kRows>
struct Tile {
  static constexpr int kThreads = kRows / kRowsPerThread;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kWarpRows = kRows / kWarps;   // rows a warp adds
  static_assert(kWarpRows == 64 && 32 % kBatch == 0, "ids: two per lane");
};

// fn(std::integral_constant<int, tile>()) for a tile the library
// instantiates (64, 128 or 256 rows); `other` for any other tile.
template <typename R, typename Fn>
R on_tile(int tile, R other, Fn fn) {
  switch (tile) {
    case 64: return fn(std::integral_constant<int, 64>());
    case 128: return fn(std::integral_constant<int, 128>());
    case 256: return fn(std::integral_constant<int, 256>());
    default: return other;
  }
}

enum PointType { kF32 = 0, kBF16 = 1, kI8 = 2 };

int pad32(int v) { return (v + 31) & ~31; }
size_t pad128(size_t v) { return (v + 127) & ~static_cast<size_t>(127); }

int elem_bytes(int dtype) {
  return dtype == kF32 ? 4 : dtype == kBF16 ? 2 : 1;
}

// Shared memory of one block: what it holds, and where.
struct Plan {
  int slots;       // staging slots (2: a ring, 1: no overlap)
  int copies;      // accumulator copies (fused form), dividing kWarps
  int kp, fp;      // K and F padded to multiples of 32
  size_t slot_bytes, smem;
  // byte offsets from the shared base
  size_t off_c2, off_scale, off_ids, off_acc, off_slot;
};

template <int kRows>
Plan make_plan(int dtype, bool fused, int f, int k, int slots, int copies) {
  Plan p;
  p.slots = slots;
  p.copies = fused ? copies : 0;
  p.kp = pad32(k);
  p.fp = pad32(f);
  // 16 spare bytes for a start address off the 16-byte grid, and whole
  // 128-byte lines, inside which the 16-byte chunks are swizzled
  p.slot_bytes =
      pad128(static_cast<size_t>(kRows) * f * elem_bytes(dtype) + 16);
  size_t off = sizeof(float) * static_cast<size_t>(p.kp) * p.fp;  // centroids
  p.off_c2 = off;
  off += sizeof(float) * p.kp;
  p.off_scale = off;
  off += sizeof(float) * p.fp;
  p.off_ids = off;
  off += fused ? sizeof(int) * kRows : 0;
  p.off_acc = off;
  off += sizeof(float) * static_cast<size_t>(p.copies) *
         (p.kp * p.fp + p.kp);
  p.off_slot = pad128(off);
  p.smem = p.off_slot + p.slots * p.slot_bytes;
  return p;
}

// The largest layout that fits: every warp its own copy and two slots, then
// one slot, then fewer copies; the smallest layout where none fits.
template <int kRows>
Plan choose_plan(int dtype, bool fused, int f, int k) {
  for (int copies = Tile<kRows>::kWarps; copies >= 1; copies /= 2) {
    for (int slots = 2; slots >= 1; --slots) {
      Plan p = make_plan<kRows>(dtype, fused, f, k, slots, copies);
      if (p.smem <= kMaxSmem) return p;
    }
    if (!fused) break;
  }
  return make_plan<kRows>(dtype, fused, f, k, 1, 1);
}

// Where byte b of a staged tile lies in its slot.  With `sw` = 7, the
// 16-byte chunks of each 128-byte line are permuted by the line's index
// (chunk i -> i ^ (line & 7)), so that the 16-byte row reads of a warp
// whose rows are a multiple of 16 bytes long spread over all banks; with
// `sw` = 0 the bytes lie in order.
__device__ __forceinline__ uint32_t swizzle(uint32_t b, uint32_t sw) {
  return b ^ (((b >> 7) & sw) << 4);
}

__device__ __forceinline__ float widen(float v, float) { return v; }
__device__ __forceinline__ float widen(uint16_t v, float) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);  // bf16 bits, exact
}
__device__ __forceinline__ float widen(int8_t v, float scale) {
  return static_cast<float>(v) * scale;  // the reference's dequantize
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(gmem)));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage the bytes [b0, b0 + nbytes) of the points into a slot, so that the
// byte at address a lands at slot + swizzle(a - align_down(b0, 16), sw).  The
// 16-byte aligned middle goes by cp.async (committed by the caller); the head
// and tail bytes, which exist only where sw = 0, by plain loads (at most
// 15 each, so one thread a byte for every block size).
template <int kThreads>
__device__ __forceinline__ void stage_tile(unsigned char* slot,
                                           const unsigned char* b0,
                                           size_t nbytes, uint32_t sw) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(b0);
  const uintptr_t a1 = a0 + nbytes;
  const uintptr_t base = a0 & ~static_cast<uintptr_t>(15);
  uintptr_t mid0 = (a0 + 15) & ~static_cast<uintptr_t>(15);
  uintptr_t mid1 = a1 & ~static_cast<uintptr_t>(15);
  if (mid0 > mid1) mid0 = mid1 = a1;   // no aligned chunk inside the range
  const int nchunks = static_cast<int>((mid1 - mid0) >> 4);
  for (int i = threadIdx.x; i < nchunks; i += kThreads) {
    const uintptr_t a = mid0 + (static_cast<uintptr_t>(i) << 4);
    cp_async16(slot + swizzle(static_cast<uint32_t>(a - base), sw),
               reinterpret_cast<const void*>(a));
  }
  const int head = static_cast<int>(mid0 - a0);
  const int tail = static_cast<int>(a1 - mid1);
  const int t = threadIdx.x;
  if (t < head) {
    slot[a0 - base + t] = *reinterpret_cast<const unsigned char*>(a0 + t);
  } else if (t - head < tail) {
    const uintptr_t a = mid1 + (t - head);
    slot[a - base] = *reinterpret_cast<const unsigned char*>(a);
  }
}

// Adds v[b] into dst[id[b] * stride] for b = 0 .. kBatch-1 in order, the
// same bits as one read-modify-write after another, but with every load
// before the first store: a row whose id an earlier row of the batch shares
// adds onto that row's new value in place of the loaded one.  Rows with
// id < 0 are skipped.
__device__ __forceinline__ void batch_add(float* dst, int stride,
                                          const int (&id)[kBatch],
                                          const float (&v)[kBatch]) {
  float run[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b)
    run[b] = id[b] >= 0 ? dst[id[b] * stride] : 0.0f;
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
#pragma unroll
    for (int e = 0; e < b; ++e)   // the nearest earlier row with this id
      if (id[e] == id[b]) run[b] = run[e];
    run[b] += v[b];
  }
#pragma unroll
  for (int b = 0; b < kBatch; ++b)
    if (id[b] >= 0) dst[id[b] * stride] = run[b];
}

// Features fc .. fc+31 of row r of a staged tile (tile: its first byte),
// widened to fp32; zero past f.  `vec`: rows start on 16-byte boundaries, so
// whole 16-byte vectors are read.
template <typename T>
__device__ __forceinline__ void load_row(const unsigned char* tile,
                                         uint32_t sw, int r, int f, int fc,
                                         const float* s_scale, bool vec,
                                         float (&xr)[kChunk]) {
  constexpr int V = 16 / sizeof(T);    // elements a 16-byte vector
  const uint32_t b0 = static_cast<uint32_t>((r * f + fc) * sizeof(T));
  if (vec) {
#pragma unroll
    for (int q = 0; q < kChunk / V; ++q) {
      if (fc + q * V < f) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            tile + swizzle(b0 + 16 * q, sw));
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < V; ++i)
          xr[q * V + i] = widen(e[i], s_scale[fc + q * V + i]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) xr[q * V + i] = 0.0f;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      xr[j] = fc + j < f
                  ? widen(*reinterpret_cast<const T*>(tile + b0 +
                                                      j * sizeof(T)),
                          s_scale[fc + j])
                  : 0.0f;
  }
}

template <int kRows, typename T, bool kFused>
__global__ void __launch_bounds__(Tile<kRows>::kThreads)
    assign_kernel(const T* __restrict__ pts, const float* __restrict__ cent,
                  const float* __restrict__ c2, const float* __restrict__ scales,
                  int n, int f, int k, Plan plan, int32_t* __restrict__ ids,
                  float* __restrict__ dmin, float* __restrict__ psums,
                  float* __restrict__ pcounts) {
  constexpr int kThreads = Tile<kRows>::kThreads;
  constexpr int kWarps = Tile<kRows>::kWarps;
  constexpr int kWarpRows = Tile<kRows>::kWarpRows;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kp = plan.kp, fp = plan.fp;
  float* s_cent = reinterpret_cast<float*>(smem);               // (kp, fp)
  float* s_c2 = reinterpret_cast<float*>(smem + plan.off_c2);   // (kp)
  float* s_scale = reinterpret_cast<float*>(smem + plan.off_scale);  // (fp)
  int* s_ids = reinterpret_cast<int*>(smem + plan.off_ids);     // (kRows)
  float* s_acc = reinterpret_cast<float*>(smem + plan.off_acc);
  unsigned char* s_slot = smem + plan.off_slot;
  const int copy_floats = kp * fp + kp;   // sums (kp, fp), then counts (kp)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ntiles = (n + kRows - 1) / kRows;
  const size_t row_bytes = static_cast<size_t>(f) * sizeof(T);
  const unsigned char* gbytes = reinterpret_cast<const unsigned char*>(pts);
  // tiles start kRows rows apart, so each starts at this offset from a
  // 16-byte boundary; rows are read as swizzled 16-byte vectors where all
  // start on one
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(pts) & 15);
  const bool vec = mis == 0 && row_bytes % 16 == 0;
  const uint32_t sw = vec ? 7u : 0u;

  auto stage = [&](int tile, int slot) {
    const long row0 = static_cast<long>(tile) * kRows;
    const int rows = static_cast<int>(min(static_cast<long>(kRows), n - row0));
    stage_tile<kThreads>(s_slot + slot * plan.slot_bytes,
                         gbytes + row0 * row_bytes, rows * row_bytes, sw);
    cp_async_commit();
  };

  int tile = blockIdx.x;
  stage(tile, 0);   // overlaps the centroids' staging below

  for (int i = tid; i < kp * fp; i += kThreads) {
    const int c = i / fp, j = i - c * fp;
    s_cent[i] = (c < k && j < f) ? cent[c * f + j] : 0.0f;
  }
  for (int c = tid; c < kp; c += kThreads) s_c2[c] = c < k ? c2[c] : INFINITY;
  for (int j = tid; j < fp; j += kThreads)
    s_scale[j] = j < f ? (scales ? scales[j] : 1.0f) : 0.0f;
  if (kFused)
    for (int i = tid; i < plan.copies * copy_floats; i += kThreads)
      s_acc[i] = 0.0f;

  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const int slot = plan.slots == 2 ? (it & 1) : 0;
    const bool more = tile + static_cast<int>(gridDim.x) < ntiles;
    if (plan.slots == 2 && more) {
      stage(tile + gridDim.x, slot ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile `tile` (and, first time, the centroids) landed

    const long row0 = static_cast<long>(tile) * kRows;
    const int rows = static_cast<int>(min(static_cast<long>(kRows), n - row0));
    const unsigned char* x = s_slot + slot * plan.slot_bytes + mis;
    // this thread's rows: tid and tid + kThreads of the tile
    float x2[kRowsPerThread], best[kRowsPerThread];
    int best_id[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      x2[r] = 0.0f;
      best[r] = INFINITY;
      best_id[r] = 0;
    }
    for (int cc = 0; cc < kp; cc += kChunk) {
      float dot[kRowsPerThread][kChunk];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int c = 0; c < kChunk; ++c) dot[r][c] = 0.0f;
      for (int fc = 0; fc < fp; fc += kChunk) {
        float xr[kRowsPerThread][kChunk];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          load_row<T>(x, sw, tid + r * kThreads, f, fc, s_scale, vec, xr[r]);
        if (cc == 0) {
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
            for (int j = 0; j < kChunk; ++j)
              x2[r] = fmaf(xr[r][j], xr[r][j], x2[r]);
        }
        const float4* cb =
            reinterpret_cast<const float4*>(s_cent + cc * fp + fc);
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
#pragma unroll
          for (int q = 0; q < kChunk / 4; ++q) {
            const float4 v = cb[c * (fp / 4) + q];
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r) {
              dot[r][c] = fmaf(xr[r][4 * q + 0], v.x, dot[r][c]);
              dot[r][c] = fmaf(xr[r][4 * q + 1], v.y, dot[r][c]);
              dot[r][c] = fmaf(xr[r][4 * q + 2], v.z, dot[r][c]);
              dot[r][c] = fmaf(xr[r][4 * q + 3], v.w, dot[r][c]);
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float cc2 = s_c2[cc + c];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float d2 = fmaxf(x2[r] - 2.0f * dot[r][c] + cc2, 0.0f);
          if (d2 < best[r]) {
            best[r] = d2;
            best_id[r] = cc + c;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int row = tid + r * kThreads;   // rows past the end are garbage
      if (row < rows) {
        ids[row0 + row] = best_id[r];
        dmin[row0 + row] = sqrtf(best[r]);
      }
      if (kFused) s_ids[row] = row < rows ? best_id[r] : -1;
    }

    if (kFused) {
      __syncthreads();
      // warp w adds the tile's rows 64w .. 64w+63 in order, kBatch at a
      // time; warps that share a copy take turns in warp order.  The valid
      // rows of a tile are a prefix, so a warp stops at its first -1.
      const int turns = kWarps / plan.copies;
      float* acc = s_acc + (warp % plan.copies) * copy_floats;
      float* cnt = acc + kp * fp;
      const int r0 = warp * kWarpRows;
      // lane l holds the ids of rows r0 + l and r0 + 32 + l
      const int id_lo = s_ids[r0 + lane], id_hi = s_ids[r0 + 32 + lane];
      for (int turn = 0; turn < turns; ++turn) {
        if (warp / plan.copies == turn) {
          for (int i0 = 0; i0 < kWarpRows; i0 += kBatch) {
            const int held = i0 < 32 ? id_lo : id_hi;
            int id[kBatch];
#pragma unroll
            for (int b = 0; b < kBatch; ++b)
              id[b] = __shfl_sync(0xffffffffu, held, (i0 & 31) + b);
            if (id[0] < 0) break;
            for (int jb = 0; jb < f; jb += 32) {
              const int j = jb + lane;
              if (j >= f) continue;
              float v[kBatch];
#pragma unroll
              for (int b = 0; b < kBatch; ++b) {
                const uint32_t e = static_cast<uint32_t>(
                    (r0 + i0 + b) * row_bytes + j * sizeof(T));
                v[b] = widen(*reinterpret_cast<const T*>(x + swizzle(e, sw)),
                             s_scale[j]);
              }
              batch_add(acc + j, fp, id, v);
            }
            if (lane == 0) {
              float one[kBatch];
#pragma unroll
              for (int b = 0; b < kBatch; ++b) one[b] = 1.0f;
              batch_add(cnt, 1, id, one);
            }
          }
        }
        if (turns > 1) __syncthreads();
      }
    }
    __syncthreads();   // the slot is free for the copy after next
    if (plan.slots == 1 && more) stage(tile + gridDim.x, 0);
  }
  if (!kFused) return;

  // this block's partial: its copies added in warp order
  float* bsums = psums + static_cast<long>(blockIdx.x) * k * f;
  for (int e = tid; e < k * f; e += kThreads) {
    const int c = e / f, j = e - c * f;
    float s = s_acc[c * fp + j];
    for (int cp = 1; cp < plan.copies; ++cp)
      s += s_acc[cp * copy_floats + c * fp + j];
    bsums[e] = s;
  }
  float* bcounts = pcounts + static_cast<long>(blockIdx.x) * k;
  for (int c = tid; c < k; c += kThreads) {
    float s = s_acc[kp * fp + c];
    for (int cp = 1; cp < plan.copies; ++cp)
      s += s_acc[cp * copy_floats + kp * fp + c];
    bcounts[c] = s;
  }
}

// Adds the per-block partials over blocks 0..nblocks-1 in order: one thread
// per output element, the K*F sums first, then the K counts.  Loads go in
// batches of 32 so that they are in flight together; the adds stay in order.
constexpr int kReduceThreads = 128;

__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials(const float* __restrict__ psums,
                    const float* __restrict__ pcounts, int nblocks, int kf,
                    int k, float* __restrict__ sums, float* __restrict__ counts) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  const float* src;
  long stride;
  float* dst;
  if (e < kf) {
    src = psums + e;
    stride = kf;
    dst = sums + e;
  } else if (e < kf + k) {
    src = pcounts + (e - kf);
    stride = k;
    dst = counts + (e - kf);
  } else {
    return;
  }
  float acc = 0.0f;
  int b = 0;
  for (; b + 32 <= nblocks; b += 32) {
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = src[(b + i) * stride];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc += v[i];
  }
  for (; b < nblocks; ++b) acc += src[b * stride];
  *dst = acc;
}

// Lets a launch of one instance take up to kMaxSmem of dynamic shared
// memory on the current device.  The attribute belongs to the instance, not
// to a shape, so it is only ever set to this one value: a call at one shape
// (or on another thread) never lowers what a launch at another shape needs.
template <int kRows, typename T, bool kFused>
cudaError_t allow_max_smem() {
  return cudaFuncSetAttribute(assign_kernel<kRows, T, kFused>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kMaxSmem));
}

template <int kRows, typename T, bool kFused>
cudaError_t max_grid(const Plan& plan, int* out) {
  cudaError_t err = allow_max_smem<kRows, T, kFused>();
  if (err != cudaSuccess) return err;
  int resident = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, assign_kernel<kRows, T, kFused>, Tile<kRows>::kThreads,
      plan.smem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *out = resident * sms;
  return resident > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int kRows, typename T, bool kFused>
cudaError_t launch_assign(const Plan& plan, const void* pts, const void* cent,
                          const void* c2, const void* scales, int n, int f,
                          int k, int grid, void* ids, void* dmin, void* psums,
                          void* pcounts, cudaStream_t stream) {
  const cudaError_t err = allow_max_smem<kRows, T, kFused>();
  if (err != cudaSuccess) return err;
  assign_kernel<kRows, T, kFused>
      <<<grid, Tile<kRows>::kThreads, plan.smem, stream>>>(
      static_cast<const T*>(pts), static_cast<const float*>(cent),
      static_cast<const float*>(c2), static_cast<const float*>(scales), n, f, k,
      plan, static_cast<int32_t*>(ids), static_cast<float*>(dmin),
      static_cast<float*>(psums), static_cast<float*>(pcounts));
  return cudaGetLastError();
}

template <int kRows, bool kFused>
cudaError_t dispatch(int dtype, const void* pts, const void* cent,
                     const void* c2, const void* scales, int n, int f, int k,
                     int grid, void* ids, void* dmin, void* psums,
                     void* pcounts, cudaStream_t stream) {
  const int tiles = (n + kRows - 1) / kRows;
  if (n <= 0 || grid < 1 || grid > tiles) return cudaErrorInvalidValue;
  const Plan plan = choose_plan<kRows>(dtype, kFused, f, k);
  if (plan.smem > kMaxSmem) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return launch_assign<kRows, float, kFused>(plan, pts, cent, c2, scales,
                                                 n, f, k, grid, ids, dmin,
                                                 psums, pcounts, stream);
    case kBF16:
      return launch_assign<kRows, uint16_t, kFused>(plan, pts, cent, c2,
                                                    scales, n, f, k, grid, ids,
                                                    dmin, psums, pcounts,
                                                    stream);
    case kI8:
      return launch_assign<kRows, int8_t, kFused>(plan, pts, cent, c2, scales,
                                                  n, f, k, grid, ids, dmin,
                                                  psums, pcounts, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the given form and tile needs at
// (f, k): the largest layout that fits, or the smallest one when none does
// (more than the 232,448 bytes of an sm_90 block; the wrapper raises then).
// SIZE_MAX for a tile the library does not hold.
size_t kmeans_smem_bytes(int dtype, int fused, int f, int k, int tile) {
  return on_tile<size_t>(tile, SIZE_MAX, [&](auto rows) {
    return choose_plan<decltype(rows)::value>(dtype, fused != 0, f, k).smem;
  });
}

// Threads of a block of either form with `tile`-row tiles; 0 for a tile the
// library does not hold.
int kmeans_block_threads(int tile) {
  return on_tile<int>(tile, 0, [](auto rows) {
    return Tile<decltype(rows)::value>::kThreads;
  });
}

// The most blocks a launch of the given form and tile takes on the current
// device: SMs x resident blocks.  A launch over n rows runs
// min(ceil(n / tile), this) blocks, and the fused form takes psums
// (blocks, k, f) and pcounts (blocks, k).  Returns a CUDA error code, the
// count in *out.
int kmeans_max_grid(int dtype, int fused, int f, int k, int tile, int* out) {
  return on_tile<int>(tile, cudaErrorInvalidValue, [&](auto rows) -> int {
    constexpr int R = decltype(rows)::value;
    const Plan plan = choose_plan<R>(dtype, fused != 0, f, k);
    if (plan.smem > kMaxSmem) return cudaErrorInvalidValue;
    switch (dtype * 2 + (fused != 0)) {
      case kF32 * 2: return max_grid<R, float, false>(plan, out);
      case kF32 * 2 + 1: return max_grid<R, float, true>(plan, out);
      case kBF16 * 2: return max_grid<R, uint16_t, false>(plan, out);
      case kBF16 * 2 + 1: return max_grid<R, uint16_t, true>(plan, out);
      case kI8 * 2: return max_grid<R, int8_t, false>(plan, out);
      case kI8 * 2 + 1: return max_grid<R, int8_t, true>(plan, out);
      default: return cudaErrorInvalidValue;
    }
  });
}

const char* kmeans_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ids (n) int32, dmin (n) f32 for points (n, f) of type dtype (0 fp32, 1 bf16
// bits, 2 int8 with scales (f)) against fp32 centroids (k, f) and |c|^2 (k),
// in tiles of `tile` rows over `grid` blocks (1 <= grid <= ceil(n / tile)).
int kmeans_assign(int dtype, int tile, const void* pts, const void* cent,
                  const void* c2, const void* scales, int n, int f, int k,
                  int grid, void* ids, void* dmin, void* stream) {
  return on_tile<int>(tile, cudaErrorInvalidValue, [&](auto rows) -> int {
    return dispatch<decltype(rows)::value, false>(
        dtype, pts, cent, c2, scales, n, f, k, grid, ids, dmin, nullptr,
        nullptr, static_cast<cudaStream_t>(stream));
  });
}

// The fused form: also sums (k, f) and counts (k), through the scratch psums
// (grid, k, f) and pcounts (grid, k).
int kmeans_assign_update(int dtype, int tile, const void* pts,
                         const void* cent, const void* c2, const void* scales,
                         int n, int f, int k, int grid, void* ids, void* dmin,
                         void* psums, void* pcounts, void* sums, void* counts,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = on_tile<int>(tile, cudaErrorInvalidValue, [&](auto rows) {
    return static_cast<int>(dispatch<decltype(rows)::value, true>(
        dtype, pts, cent, c2, scales, n, f, k, grid, ids, dmin, psums,
        pcounts, s));
  });
  if (err != cudaSuccess) return err;
  const int kf = k * f;
  reduce_partials<<<(kf + k + kReduceThreads - 1) / kReduceThreads,
                    kReduceThreads, 0, s>>>(
      static_cast<const float*>(psums), static_cast<const float*>(pcounts),
      grid, kf, k, static_cast<float*>(sums), static_cast<float*>(counts));
  return cudaGetLastError();
}

}  // extern "C"
