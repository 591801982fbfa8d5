// One decode step's attention core for Hopper (sm_90a): rope of the new
// query and key, the new key and value written into the cache, and grouped
// attention of the query heads over the cache's valid keys, in one launch.
//
// Replaces no Pallas kernel: the reference's decode attention is plain jnp
// (repro/models/layers.py gqa_decode :257 and attention_decode :187), which
// XLA fuses.  Op by op in PyTorch the same step is ~37 kernels a layer
// (two ropes, two slot writes, the ring arithmetic, the fp32 copy of the K
// cache, einsum's layout copies of K and V, the mask, the softmax, the
// output's widening), and the copies move ~5 GB a step at hymba-1.5b's
// decode shapes for ~0.5 GB of cache that the step needs.
//
// What it computes, for batch row b and kv group g, with L the position
// (a 0-d device integer), S the cache's slots and R = H / Hkv the group's
// query heads:
//   slot  = L % S and valid = min(L + 1, S) for a ring buffer (a sliding
//           window), slot = L and valid = L + 1 otherwise;
//   q_r   = rope(q_r), k = rope(k), each rounded to the inputs' type, the
//           rotate-half formula with one rounding a product and a sum, as
//           PyTorch's elementwise ops give it;
//   cache[b, slot, g] = k and v, in the cache's type;
//   s_rj  = (q_r . K_j) * scale (1 / sqrt(D) unless the caller gives one)
//           over the keys j < valid, in fp32,
//           K widened from the cache (the new key as rounded into it);
//   p_rj  = exp(s_rj - max_j s_rj) / sum_j exp(...), rounded to the
//           cache's type;
//   o_r   = sum_j p_rj V_j in fp32, rounded to the cache's type,
// and writes o (B, H*D) in fp32, or bf16 where the inputs and the cache both
// are.  That is the op-by-op step's arithmetic in its order; the only
// difference is the order of the sums (keys past `valid` add exact zeros
// there and are not read here), and no online rescaling: p is rounded once,
// from the final max and sum.
//
// What bounds it on an H100: bytes.  A step reads each valid key and value
// row once (2 * valid * D * 2 B a group for a bf16 cache) and does 4 * R * D
// flops a key, ~1 flop a byte at hymba-1.5b's R 5, D 64: at decode_heavy's
// shapes (B 16, Hkv 5, ~768 valid keys) ~16 MB a layer, ~4.8 us at 3.35
// TB/s.  What holds it back there (20 us a launch on an H100): the
// instructions its loops issue and their latency, not its loads, and ~7 us
// of fixed costs a block (the first tile's arrival, the softmax's two
// cluster exchanges, the combine of the partial outputs).
//
// What this design does about it:
// - One thread-block cluster per (b, g), of C blocks (a power of two up to
//   8, from the shapes: enough blocks for two an SM of 132, and shared
//   memory for the scores).  The group's R query heads share every key and
//   value read (GQA reuse).  The valid keys are cut into C slices of whole
//   32-key tiles, one slice a block.
// - Each block streams its slice's K tiles, then its V tiles, through one
//   cp.async ring of 16-byte copies (up to 6 slots, ~32 KB in flight), so
//   the first V tiles are in flight while the softmax is formed.  Rows are
//   padded by 16 bytes, so lane i reading row i hits no bank twice.
// - Few instructions a key, since they, not the loads, bound the loops.
//   Scores:
//   lane i of warp w owns key i of the tile and the heads w, w + 8 (one
//   template instance a group width, every loop over heads unrolled), each
//   dot over D in two interleaved FMA chains against the roped query in
//   shared memory (a broadcast); no partial sums to reduce.  A block keeps
//   its slice's scores in shared memory; the row max and the row sum are
//   combined across the cluster through distributed shared memory, in rank
//   order; then p is formed in place.
// - p.v: thread (c, s) owns two columns c of every head over the keys
//   [s, s + 1) * kpt of each tile, four keys' loads at a time; the key
//   splits' partials, then the cluster's, are added in a fixed order by
//   the block that writes the output.  No second launch, no scratch in
//   device memory, no atomics: a launch's result does not depend on
//   timing, so a graph replay gives the eager launch's bits.
// - The block whose slice holds the slot writes the new k and v into the
//   cache and reads them from shared memory, not from the stale row its
//   copies may have fetched; no other block reads that row.
//
// C interface for ctypes: every pointer and the stream are void*, and the
// entry point returns cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                    // keys a tile: one a lane
constexpr int kMaxRep = 16;                  // query heads a kv group
constexpr int kMaxCluster = 8;               // the portable cluster size
constexpr int kRingBytes = 32 * 1024;
constexpr int kMaxStages = 6;
constexpr int kTargetBlocks = 2 * 132;       // two blocks an SM of an H100
constexpr size_t kMaxSmem = 232448;          // an sm_90 block's maximum

enum ElemType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T's precision, kept as fp32
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  return widen(narrow<T>(x));
}
// element j of an input row of fp32 (bf16 false) or bf16 values
__device__ __forceinline__ float input_at(const void* row, int j, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(row)[j])
              : static_cast<const float*>(row)[j];
}

// eight consecutive elements (16-byte aligned), widened to fp32
__device__ __forceinline__ void ld8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w;
  o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
// two consecutive elements (aligned to their pair), widened to fp32
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of this thread's copy groups are pending (n < 5)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
  }
}
// n bytes (a multiple of 16, both ends 16-byte aligned) copied to shared
// memory by the block's threads, in the open copy group
__device__ __forceinline__ void stage(void* dst, const void* src, int n) {
  for (int c = threadIdx.x; c < n / 16; c += kThreads)
    cp_async16(static_cast<char*>(dst) + 16 * c,
               static_cast<const char*>(src) + 16 * c);
}

// The launch's geometry and the block's shared-memory layout (byte
// offsets), the same on the host and in the kernel.
struct Plan {
  int cluster;     // blocks a (b, g)
  int stages;      // slots of the tile ring
  int tiles_max;   // 32-key tiles of the longest slice
  int row_bytes;   // a ring row: D elements and 16 bytes of padding
  int off_q;       // roped queries (R, D) fp32; the partial outputs later
  int off_knew;    // the new k and v rows, in the cache's type
  int off_vnew;
  int off_raw;     // q, k, v, cos and sin as they land
  int off_sc;      // scores, then p: (R, tiles_max * 32) fp32
  int off_red;     // row max and sum: this block's, then the cluster's
  size_t smem;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

void lay_out(Plan& p, int es, int qs, int s, int rep, int d) {
  const int s_tiles = (s + kTile - 1) / kTile;
  p.tiles_max = (s_tiles + p.cluster - 1) / p.cluster;
  // the ring; after the last tile, the p.v partials of the key splits
  const int splits = kThreads / (d / 2);
  const int ring = p.stages * kTile * p.row_bytes;
  const int pv = splits * rep * d * 4;
  p.off_q = align16(ring > pv ? ring : pv);
  p.off_knew = p.off_q + align16(rep * d * 4);
  p.off_vnew = p.off_knew + align16(d * es);
  p.off_raw = p.off_vnew + align16(d * es);
  p.off_sc = p.off_raw + align16(rep * d * qs) + 2 * align16(d * qs) +
             2 * align16(d * 2);
  p.off_red = p.off_sc + rep * p.tiles_max * kTile * 4;
  p.smem = static_cast<size_t>(p.off_red) + 4 * kMaxRep * 4;
}

Plan plan_for(int es, int qs, int b, int s, int hkv, int rep, int d) {
  Plan p{};
  p.row_bytes = d * es + 16;
  const int tile = kTile * p.row_bytes;
  p.stages = kRingBytes / tile;
  p.stages = p.stages < 2 ? 2 : p.stages > kMaxStages ? kMaxStages : p.stages;
  const int s_tiles = (s + kTile - 1) / kTile;
  // enough blocks to fill the card, each slice at least a tile
  p.cluster = 1;
  while (p.cluster < kMaxCluster && 2 * p.cluster <= s_tiles &&
         static_cast<long>(b) * hkv * p.cluster < kTargetBlocks)
    p.cluster *= 2;
  lay_out(p, es, qs, s, rep, d);
  // more blocks where one block's scores do not fit
  while (p.smem > kMaxSmem && p.cluster < kMaxCluster &&
         2 * p.cluster <= s_tiles) {
    p.cluster *= 2;
    lay_out(p, es, qs, s, rep, d);
  }
  return p;
}

struct Args {
  const void* q;       // (B, H, D) unroped, fp32 or bf16 (q_bf16)
  const void* k;       // (B, Hkv, D) unroped, q's type
  const void* v;       // (B, Hkv, D), q's type
  void* kc;            // (B, S, Hkv, D), type TC
  void* vc;
  const void* length;  // 0-d int32 or int64
  const float* cos;    // (1 or B, D / 2) fp32, or null: no rope
  const float* sin;
  void* out;           // (B, H * D), fp32, or bf16 where TC and q are
  float inv_sqrt_d;
  int q_bf16, len64, cos_rows, ring, s, hkv, rep, d;
  Plan plan;
};

// One (batch row, kv group) per cluster, the cluster's blocks splitting its
// valid keys.  kRep bounds the group's query heads (rep <= kRep): every
// per-head loop is unrolled to it.
template <typename TC, int kRep>
__global__ void __launch_bounds__(kThreads, 3)
    decode_attention_kernel(const Args a) {
  constexpr int kRW = (kRep + kWarps - 1) / kWarps;  // heads a warp scores
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = a.d, rep = a.rep, S = a.s, hkv = a.hkv, h = hkv * rep;
  const bool qbf = a.q_bf16 != 0;
  const Plan& pl = a.plan;

  const long long len = a.len64 ? *static_cast<const long long*>(a.length)
                                : *static_cast<const int*>(a.length);
  // an out-of-range position is a device fault, as PyTorch's index_copy_
  if (len < 0 || (!a.ring && len >= S)) __trap();
  const int widx = a.ring ? static_cast<int>(len % S) : static_cast<int>(len);
  const int valid = a.ring ? static_cast<int>(len + 1 < S ? len + 1 : S)
                           : static_cast<int>(len + 1);
  // this block's slice [lo, hi) of the valid keys, whole tiles
  const int vt = (valid + kTile - 1) / kTile;
  const int per = (vt + nc - 1) / nc * kTile;
  const int lo = rank * per;
  const int hi = min(lo + per, valid);
  const int n = max(hi - lo, 0);
  const int nt = (n + kTile - 1) / kTile;

  const int rowe = pl.row_bytes / static_cast<int>(sizeof(TC));
  TC* ring = reinterpret_cast<TC*>(smem);
  float* pvred = reinterpret_cast<float*>(smem);  // the ring's room, last
  float* qs = reinterpret_cast<float*>(smem + pl.off_q);
  float* part = qs;  // the queries' room, once the scores are done
  TC* knew = reinterpret_cast<TC*>(smem + pl.off_knew);
  TC* vnew = reinterpret_cast<TC*>(smem + pl.off_vnew);
  float* sc = reinterpret_cast<float*>(smem + pl.off_sc);
  float* red = reinterpret_cast<float*>(smem + pl.off_red);
  float* rmax = red;
  float* rsum = red + kMaxRep;
  float* gmax = red + 2 * kMaxRep;
  float* gsum = red + 3 * kMaxRep;
  const int ldsc = pl.tiles_max * kTile;

  const long kv_row = static_cast<long>(hkv) * d;  // elements a key apart
  TC* kbase = static_cast<TC*>(a.kc) + static_cast<long>(b) * S * kv_row +
              static_cast<long>(g) * d;
  TC* vbase = static_cast<TC*>(a.vc) + static_cast<long>(b) * S * kv_row +
              static_cast<long>(g) * d;

  // The stream of tiles: the slice's K tiles, then its V tiles, one copy
  // group each, through a ring of `stages` slots.  Thread tid copies the
  // 16-byte piece cr of rows r0, r0 + rstep, ... of every tile; the rows
  // past the slice are not loaded.
  const int total = 2 * nt;
  const int chunks = d * static_cast<int>(sizeof(TC)) / 16;
  const int rstep = kThreads / chunks;
  const int r0 = tid / chunks;
  const int cr = (tid - r0 * chunks) * (16 / static_cast<int>(sizeof(TC)));
  const long tile_elems = kTile * kv_row;
  const TC* ksrc = kbase + (lo + r0) * kv_row + cr;
  const TC* vsrc = vbase + (lo + r0) * kv_row + cr;
  int next = 0, next_slot = 0;  // the next tile to issue, and its slot
  auto issue = [&]() {
    if (next < total && r0 < rstep) {
      const bool is_v = next >= nt;
      const int tt = is_v ? next - nt : next;
      const int rows = min(kTile, n - tt * kTile);
      const TC* src = (is_v ? vsrc : ksrc) + tt * tile_elems;
      TC* dst = ring + (next_slot * kTile + r0) * rowe + cr;
      for (int r = r0; r < rows; r += rstep) {
        cp_async16(dst, src);
        dst += rstep * rowe;
        src += rstep * kv_row;
      }
    }
    cp_async_commit();
    ++next;
    next_slot = next_slot + 1 == pl.stages ? 0 : next_slot + 1;
  };

  // the group's queries, the new k and v and the rope's tables land with
  // the first tile
  const int half = d / 2;
  const int qsz = qbf ? 2 : 4;
  unsigned char* qraw = smem + pl.off_raw;
  unsigned char* kraw = qraw + align16(rep * d * qsz);
  unsigned char* vraw = kraw + align16(d * qsz);
  float* cs = reinterpret_cast<float*>(vraw + align16(d * qsz));
  float* sn = cs + align16(d * 2) / 4;
  const long kv_in = (static_cast<long>(b) * hkv + g) * d;
  stage(qraw, static_cast<const char*>(a.q) +
                  (static_cast<long>(b) * h + static_cast<long>(g) * rep) *
                      d * qsz,
        rep * d * qsz);
  stage(kraw, static_cast<const char*>(a.k) + kv_in * qsz, d * qsz);
  stage(vraw, static_cast<const char*>(a.v) + kv_in * qsz, d * qsz);
  if (a.cos != nullptr) {
    const long crow = a.cos_rows > 1 ? static_cast<long>(b) * half : 0;
    stage(cs, a.cos + crow, half * 4);
    stage(sn, a.sin + crow, half * 4);
  }
  for (int t = 0; t < pl.stages - 1; ++t) issue();
  cp_async_wait(pl.stages - 2);
  __syncthreads();
  // rope: one rounding a product and a sum, then the inputs' type
  for (int i = tid; i < (rep + 1) * half; i += kThreads) {
    const int r = i / half, j = i - r * half;
    const void* x = r < rep ? qraw + r * d * qsz : kraw;
    const float x1 = input_at(x, j, qbf), x2 = input_at(x, j + half, qbf);
    float o1 = x1, o2 = x2;
    if (a.cos != nullptr) {
      o1 = __fsub_rn(__fmul_rn(x1, cs[j]), __fmul_rn(x2, sn[j]));
      o2 = __fadd_rn(__fmul_rn(x1, sn[j]), __fmul_rn(x2, cs[j]));
    }
    if (qbf) o1 = round_bf16(o1), o2 = round_bf16(o2);
    if (r < rep) {
      qs[r * d + j] = o1;
      qs[r * d + j + half] = o2;
    } else {
      knew[j] = narrow<TC>(o1);
      knew[j + half] = narrow<TC>(o2);
      vnew[j] = narrow<TC>(input_at(vraw, j, qbf));
      vnew[j + half] = narrow<TC>(input_at(vraw, j + half, qbf));
    }
  }
  __syncthreads();
  if (lo <= widx && widx < hi) {
    TC* kdst = kbase + widx * kv_row;
    TC* vdst = vbase + widx * kv_row;
    for (int j = tid; j < d; j += kThreads) {
      kdst[j] = knew[j];
      vdst[j] = vnew[j];
    }
  }

  // scores of the slice: lane = key of the tile, warp w = heads w, w + 8;
  // each dot over D in two interleaved halves (two FMA chains)
  float mx[kRW];
#pragma unroll
  for (int i = 0; i < kRW; ++i) mx[i] = -INFINITY;
  int slot = 0;
  for (int t = 0; t < nt; ++t) {
    cp_async_wait(pl.stages - 2);
    __syncthreads();  // tile t has landed; slot t - 1 is free
    issue();
    const int key = lo + t * kTile + lane;
    if (warp < rep && key < hi) {
      const TC* row = key == widx ? knew : ring + (slot * kTile + lane) * rowe;
      float acc[kRW][2];
#pragma unroll
      for (int i = 0; i < kRW; ++i) acc[i][0] = acc[i][1] = 0.f;
      for (int c = 0; c < d; c += 16) {
        float k0[8], k1[8];
        ld8(row + c, k0);
        ld8(row + c + 8, k1);
#pragma unroll
        for (int i = 0; i < kRW; ++i) {
          const int r = warp + i * kWarps;
          if (i == 0 || r < rep) {
            float q0[8], q1[8];
            ld8(qs + r * d + c, q0);
            ld8(qs + r * d + c + 8, q1);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              acc[i][0] = fmaf(q0[e], k0[e], acc[i][0]);
              acc[i][1] = fmaf(q1[e], k1[e], acc[i][1]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        const int r = warp + i * kWarps;
        if (i == 0 || r < rep) {
          const float s = (acc[i][0] + acc[i][1]) * a.inv_sqrt_d;
          sc[r * ldsc + t * kTile + lane] = s;
          mx[i] = fmaxf(mx[i], s);
        }
      }
    }
    slot = slot + 1 == pl.stages ? 0 : slot + 1;
  }
#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    const int r = warp + i * kWarps;
    float m = mx[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (r < rep && lane == 0) rmax[r] = m;
  }
  cluster.sync();  // every block's max is written
  if (tid < rep) {
    float v[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      v[c] = c < nc ? cluster.map_shared_rank(rmax, c)[tid] : -INFINITY;
    float m = v[0];
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c) m = fmaxf(m, v[c]);
    gmax[tid] = m;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    const int r = warp + i * kWarps;
    float sum = 0.f;
    if (r < rep) {
      const float m = gmax[r];
      for (int j = lane; j < n; j += 32) {
        const float e = expf(sc[r * ldsc + j] - m);
        sc[r * ldsc + j] = e;
        sum += e;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (r < rep && lane == 0) rsum[r] = sum;
  }
  cluster.sync();  // every block's sum is written
  if (tid < rep) {
    float v[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      v[c] = c < nc ? cluster.map_shared_rank(rsum, c)[tid] : 0.f;
    float l = v[0];
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c)
      if (c < nc) l += v[c];
    gsum[tid] = l;
  }
  __syncthreads();
  // p in the cache's type
#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    const int r = warp + i * kWarps;
    if (r < rep) {
      const float l = gsum[r];
      for (int j = lane; j < n; j += 32)
        sc[r * ldsc + j] = round_as<TC>(sc[r * ldsc + j] / l);
    }
  }

  // p.v over the slice: thread (cp, ks) owns columns 2cp, 2cp + 1 of every
  // head over the keys [ks, ks + 1) * kpt of each tile, four keys' loads at
  // a time; the key splits' sums are added in split order at the end
  const int cols = d / 2;
  const int splits = kThreads / cols;
  const int kpt = (kTile + splits - 1) / splits;
  const int cp = tid % cols, ks = tid / cols;
  const int j0 = ks * kpt, j1 = min(j0 + kpt, kTile);
  float acc[kRep][2];
#pragma unroll
  for (int r = 0; r < kRep; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int t = 0; t < nt; ++t) {
    cp_async_wait(pl.stages - 2);
    __syncthreads();  // V tile t has landed; the slot before it is free
    issue();
    if (ks < splits) {
      const TC* tile = ring + slot * kTile * rowe + 2 * cp;
      const float* pt = sc + t * kTile;
      const int jn = min(j1, n - t * kTile);  // rows past the slice: unread
      const int kw = widx - lo - t * kTile;      // the new row, if here
      int jj = j0;
      for (; jj + 4 <= jn; jj += 4) {
        float2 vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          vv[u] = ld2(jj + u == kw ? vnew + 2 * cp : tile + (jj + u) * rowe);
#pragma unroll
        for (int r = 0; r < kRep; ++r) {
          if (r < rep) {
            const float* pr = pt + r * ldsc + jj;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[r][0] = fmaf(pr[u], vv[u].x, acc[r][0]);
              acc[r][1] = fmaf(pr[u], vv[u].y, acc[r][1]);
            }
          }
        }
      }
      for (; jj < jn; ++jj) {
        const float2 vv = ld2(jj == kw ? vnew + 2 * cp : tile + jj * rowe);
#pragma unroll
        for (int r = 0; r < kRep; ++r) {
          if (r < rep) {
            const float p = pt[r * ldsc + jj];
            acc[r][0] = fmaf(p, vv.x, acc[r][0]);
            acc[r][1] = fmaf(p, vv.y, acc[r][1]);
          }
        }
      }
    }
    slot = slot + 1 == pl.stages ? 0 : slot + 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // every copy has landed and been read: the ring is free
  if (ks < splits) {
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
      if (r < rep) {
        pvred[(ks * rep + r) * d + 2 * cp] = acc[r][0];
        pvred[(ks * rep + r) * d + 2 * cp + 1] = acc[r][1];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < rep * d; e += kThreads) {
    float o = pvred[e];
    for (int k2 = 1; k2 < splits; ++k2) o += pvred[k2 * rep * d + e];
    part[e] = o;
  }
  cluster.sync();  // every block's partial output is written
  const long out0 =
      (static_cast<long>(b) * h + static_cast<long>(g) * rep) * d;
  const bool out_bf16 = qbf && sizeof(TC) == 2;
  for (int e = rank * kThreads + tid; e < rep * d; e += nc * kThreads) {
    float v[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      v[c] = c < nc ? cluster.map_shared_rank(part, c)[e] : 0.f;
    float o = v[0];
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c)
      if (c < nc) o += v[c];
    o = round_as<TC>(o);
    if (out_bf16)
      static_cast<__nv_bfloat16*>(a.out)[out0 + e] = __float2bfloat16_rn(o);
    else
      static_cast<float*>(a.out)[out0 + e] = o;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename TC, int kRep>
cudaError_t launch(const Args& args, int b, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<TC, kRep>;
  // the maximum, set before every launch and never lowered
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(args.plan.cluster, args.hkv, b);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = args.plan.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = args.plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One instance a group width the served models have (1, 2, 4, 5, 6, 7, 8,
// 12 and 16 query heads a kv head); another width runs the next one up.
template <typename TC>
cudaError_t by_rep(const Args& args, int b, cudaStream_t stream) {
  const int r = args.rep;
  if (r <= 1) return launch<TC, 1>(args, b, stream);
  if (r <= 2) return launch<TC, 2>(args, b, stream);
  if (r <= 4) return launch<TC, 4>(args, b, stream);
  if (r <= 5) return launch<TC, 5>(args, b, stream);
  if (r <= 6) return launch<TC, 6>(args, b, stream);
  if (r <= 7) return launch<TC, 7>(args, b, stream);
  if (r <= 8) return launch<TC, 8>(args, b, stream);
  if (r <= 12) return launch<TC, 12>(args, b, stream);
  return launch<TC, 16>(args, b, stream);
}

bool shapes_ok(int cache_type, int q_type, int b, int s, int hkv, int rep,
               int d) {
  return (cache_type == kF32 || cache_type == kBF16) &&
         (q_type == kF32 || q_type == kBF16) && b > 0 && s > 0 && hkv > 0 &&
         rep > 0 && rep <= kMaxRep && d > 0 && d <= 256 && d % 16 == 0 &&
         b <= 65535 && hkv <= 65535;
}

}  // namespace

extern "C" {

// The launch's dynamic shared memory a block (bytes) and its cluster size,
// for a cache of type cache_type (0 fp32, 1 bf16) and inputs of q_type; 0
// for shapes the kernel does not take.  Above 232,448 bytes the scores do
// not fit.
size_t decode_attention_smem(int cache_type, int q_type, int b, int s,
                             int hkv, int rep, int d, int* cluster) {
  if (!shapes_ok(cache_type, q_type, b, s, hkv, rep, d)) return 0;
  const Plan p = plan_for(cache_type == kBF16 ? 2 : 4,
                          q_type == kBF16 ? 2 : 4, b, s, hkv, rep, d);
  *cluster = p.cluster;
  return p.smem;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (b, hkv * rep, d), k and v (b, hkv, d) contiguous in q_type; caches
// (b, s, hkv, d) contiguous in cache_type, updated in place at the slot;
// length a 0-d int32 (len64 0) or int64 (len64 1) on the device; cos and
// sin (cos_rows, d / 2) fp32 with cos_rows 1 or b, or null; ring 1 for a
// sliding-window ring buffer; scale the scores' factor, 0 for 1 / sqrt(d).
// Writes out (b, hkv * rep * d), bf16 where both types are bf16, else fp32.
int decode_attention_fwd(int cache_type, int q_type, const void* q,
                         const void* k, const void* v, void* k_cache,
                         void* v_cache, const void* length, int len64,
                         const void* cos, const void* sin, int cos_rows,
                         int ring, int b, int s, int hkv, int rep, int d,
                         float scale, void* out, void* stream) {
  if (!shapes_ok(cache_type, q_type, b, s, hkv, rep, d) ||
      (cos != nullptr && cos_rows != 1 && cos_rows != b))
    return cudaErrorInvalidValue;
  Args args{};
  args.q = q, args.k = k, args.v = v, args.kc = k_cache, args.vc = v_cache;
  args.length = length;
  args.cos = static_cast<const float*>(cos);
  args.sin = static_cast<const float*>(sin);
  args.out = out;
  // as PyTorch divides by a host scalar on the card: times its reciprocal
  args.inv_sqrt_d =
      scale > 0.0f ? scale
                   : 1.0f / static_cast<float>(sqrt(static_cast<double>(d)));
  args.q_bf16 = q_type == kBF16;
  args.len64 = len64, args.cos_rows = cos_rows, args.ring = ring;
  args.s = s, args.hkv = hkv, args.rep = rep, args.d = d;
  args.plan = plan_for(cache_type == kBF16 ? 2 : 4,
                       q_type == kBF16 ? 2 : 4, b, s, hkv, rep, d);
  if (args.plan.smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cache_type == kBF16 ? by_rep<__nv_bfloat16>(args, b, st)
                             : by_rep<float>(args, b, st);
}

}  // extern "C"
