// One Mamba2 decode step's recurrence for Hopper (sm_90a): the causal conv
// window's step, dt, the state update in place in the cache and y = C.h + D.x,
// in one launch a layer.
//
// Replaces no Pallas kernel: the reference's SSM decode is plain jnp
// (repro/models/layers.py ssm_decode), which XLA fuses.  Op by op in PyTorch
// the same step (layers.ssm_decode, then transformer._store) is ~20 kernels
// a layer, and five of them pass over the whole (B, nh, hd, ds) fp32 state:
// the update's outer product, dA.h, the sum, the C contraction and the copy
// into the cache, ~1.3 GB a layer at granite-4.0-h-small's batch_decode
// shapes where the recurrence needs one read and one write (268 MB).
//
// What it computes, for batch row b, head h of group g = h / (nh / ng), p
// < hd and n < ds, with K = d_conv and T the conv window's type:
//   u_c   = silu(sum_k window_k,c * w_k,c + bias_c) over the K - 1 cached
//           entries and the new xbc, every channel c of the head's x and of
//           the group's B and C, with the op-by-op step's roundings to T
//           (the sum, the bias's sum, the sigmoid, the product); the window
//           is shifted by one in place, the new xbc last;
//   dt    = softplus(dt_raw + dt_bias), dA = exp(dt * -exp(A_log)), fp32;
//   h'_pn = dA * h_pn + (dt * x_p) * B_n, each product and the sum rounded
//           as the op-by-op step rounds them (no fused multiply-add), in
//           fp32, written over h in the cache;
//   y_p   = sum_n h'_pn C_n + x_p * D, fp32, rounded to T once.
// That is the op-by-op step's arithmetic in its order; the only difference
// is the order of the d_state sum (and of the conv's K terms).
//
// What bounds it on an H100: bytes.  The state is read once and written
// once, 2 * B * nh * hd * ds * 4 B, and the conv window, xbc, dt_raw and y
// add ~3% at ds 128: at granite-4.0-h-small's batch_decode (B 32, nh 128,
// hd 64, ds 128) ~277 MB a layer, 83 us at 3.35 TB/s, against 268 MB for
// the state alone.  The work is ~5 flops a state element, ~0.6 flop a byte,
// far below the card's ~200 flops a byte.  At hymba-1.5b's decode_heavy
// (B 16, nh 50, ds 16) the bytes are ~8 MB, 2.4 us, and the launch and the
// latency of two dependent loads bound it instead.
//
// What this design does about it:
// - One thread-block cluster per (b, g) of C blocks of 128 threads (C the
//   largest power of two up to 16 and up to the group's heads; 16 is
//   sm_90's non-portable cluster size); block r of the cluster takes the
//   group's heads r, r + C, r + 2C, ...  Every block computes the group's B
//   and C channels once (its heads share them), and its heads' x channels,
//   which no other block reads.  At granite's shapes that is 32 clusters
//   of 16 blocks, 8 heads a block: every cluster resident at once (35 fit
//   at 92 registers a thread).  Clusters of 8, or blocks of 256 threads,
//   leave 2 to 4 clusters to a second wave and took 0.132-0.172 ms on an
//   H100 SXM at 700 W, against 0.119 ms for this design.
// - The conv window's shift: a block writes its heads' x channels' window
//   in place right after it has read it.  The B and C channels' window is
//   read by every block of the cluster, so only block 0 writes it, after a
//   cluster barrier that every block arrives at once it has read the
//   window (arrive with release, wait with acquire, the wait at the block's
//   end): no read of the old window can see the new one.  The barrier is
//   the hardware's, reset by every launch, so it holds under graph replay
//   and needs no counter in device memory.
// - The state: lanes hold four consecutive d_state elements (one 16-byte
//   load), ds / 4 lanes a row of a head; a thread holds 4 rows (ds 128) or
//   2 (ds 16) a batch, in two batches of registers: the next batch loads
//   while the last is updated.  The first batch is loaded before the conv,
//   so its loads overlap the conv's.  Each row is updated, stored, and
//   contracted with C in registers; the ds / 4 lanes of a row add their
//   partial sums with shuffles in a fixed order, and the row's first lane
//   writes y.  No atomics, no scratch in device memory: a launch's bits do
//   not depend on timing, so a graph replay gives the eager launch's bits.
//
// C interface for ctypes: every pointer and the stream are void*, and the
// entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxCluster = 16;              // sm_90's largest (non-portable)
constexpr int kMaxConv = 8;                  // d_conv up to this
constexpr size_t kMaxSmem = 48 * 1024;       // without an opt-in

enum ElemType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

struct Args {
  const void* xbc;       // (b, conv_dim) in T, rows xbc_stride apart
  const void* dt_raw;    // (b, nh) in T, rows dt_stride apart
  void* conv;            // (b, d_conv - 1, conv_dim) in T, in place
  float* state;          // (b, nh, hd, ds) fp32, in place
  const void* conv_w;    // (d_conv, conv_dim) in T
  const void* conv_b;    // (conv_dim,) in T
  const float* dt_bias;  // (nh,)
  const float* a_log;    // (nh,)
  const float* d;        // (nh,)
  void* out;             // (b, nh * hd) in T
  long xbc_stride, dt_stride;
  int nh, ng, d_conv, cluster, heads_max;
};

// the block's heads' x, the group's B and C, and each head's dt, dA and D
struct Smem {
  float *x, *B, *C, *dt, *da, *dd;
};

template <int DS, int HD>
__device__ __forceinline__ Smem carve(float* base, int heads_max) {
  Smem s;
  s.x = base;
  s.B = s.x + heads_max * HD;
  s.C = s.B + DS;
  s.dt = s.C + DS;
  s.da = s.dt + heads_max;
  s.dd = s.da + heads_max;
  return s;
}

template <int DS, int HD>
__host__ __device__ constexpr int smem_floats(int heads_max) {
  return heads_max * HD + 2 * DS + 3 * heads_max;
}

template <typename T, int DS, int HD>
__global__ void __launch_bounds__(kThreads, 4)
    ssm_decode_kernel(const Args a) {
  constexpr int kLanesRow = DS / 4;              // lanes a state row
  constexpr int kRowsPass = kThreads / kLanesRow;
  constexpr int kRowsThread = DS >= 64 ? 4 : 2;  // rows a batch, a thread
  constexpr int kRowsBatch = kRowsPass * kRowsThread;
  extern __shared__ float4 smem_raw[];
  const Smem sm = carve<DS, HD>(reinterpret_cast<float*>(smem_raw),
                                a.heads_max);
  const int tid = threadIdx.x;
  const int rank = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int nc = a.cluster, rep = a.nh / a.ng;
  const int heads = (rep - rank + nc - 1) / nc;   // this block's
  const int rows = heads * HD;
  const int d_in = a.nh * HD;
  const int conv_dim = d_in + 2 * a.ng * DS;
  const int k1 = a.d_conv - 1;
  // the global head of this block's k-th head
  auto head_of = [&](int k) { return g * rep + rank + nc * k; };

  const int lane_col = (tid % kLanesRow) * 4;
  const int row_slot = tid / kLanesRow;
  auto state_row = [&](int row) {
    const int k = row / HD, p = row % HD;
    return a.state +
           ((static_cast<size_t>(b) * a.nh + head_of(k)) * HD + p) * DS +
           lane_col;
  };
  auto load = [&](float4(&v)[kRowsThread], int base) {
#pragma unroll
    for (int i = 0; i < kRowsThread; ++i) {
      const int row = base + i * kRowsPass + row_slot;
      if (row < rows)
        v[i] = __ldcs(reinterpret_cast<const float4*>(state_row(row)));
    }
  };
  // the first batch of state rows, in flight during the conv
  float4 va[kRowsThread], vb[kRowsThread];
  load(va, 0);

  // the conv window's step: the group's B and C channels, then the block's
  // heads' x channels (whose window this block shifts in place)
  T* conv = static_cast<T*>(a.conv) + static_cast<size_t>(b) * k1 * conv_dim;
  const T* xbc = static_cast<const T*>(a.xbc) + b * a.xbc_stride;
  const T* w = static_cast<const T*>(a.conv_w);
  const T* bias = static_cast<const T*>(a.conv_b);
  for (int i = tid; i < 2 * DS + rows; i += kThreads) {
    int c;
    float* dst;
    if (i < 2 * DS) {
      c = d_in + (i < DS ? g * DS + i : (a.ng + g) * DS + i - DS);
      dst = i < DS ? sm.B + i : sm.C + i - DS;
    } else {
      const int j = i - 2 * DS;
      c = head_of(j / HD) * HD + j % HD;
      dst = sm.x + j;
    }
    T win[kMaxConv];
#pragma unroll
    for (int k = 0; k < kMaxConv; ++k)
      if (k < k1) win[k] = conv[static_cast<size_t>(k) * conv_dim + c];
    const T now = xbc[c];
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxConv; ++k)
      if (k < k1)
        acc = fmaf(widen(win[k]), widen(w[static_cast<size_t>(k) * conv_dim +
                                          c]),
                   acc);
    acc = fmaf(widen(now), widen(w[static_cast<size_t>(k1) * conv_dim + c]),
               acc);
    // einsum's result in T, the bias's sum, sigmoid, the product: as the
    // op-by-op step rounds each
    const float pre = round_as<T>(__fadd_rn(round_as<T>(acc), widen(bias[c])));
    const float sig = round_as<T>(1.0f / (1.0f + expf(-pre)));
    *dst = round_as<T>(__fmul_rn(pre, sig));
    if (i >= 2 * DS) {  // an x channel: only this block reads its window
#pragma unroll
      for (int k = 0; k + 1 < kMaxConv; ++k)
        if (k + 1 < k1) conv[static_cast<size_t>(k) * conv_dim + c] = win[k + 1];
      conv[static_cast<size_t>(k1 - 1) * conv_dim + c] = now;
    }
  }
  // this block has read the B and C window: block 0 may shift it
  cluster_arrive();
  for (int k = tid; k < heads; k += kThreads) {
    const int h = head_of(k);
    const float raw = widen(static_cast<const T*>(a.dt_raw)[b * a.dt_stride +
                                                            h]);
    const float x = __fadd_rn(raw, a.dt_bias[h]);
    const float dt = x > 20.0f ? x : log1pf(expf(x));  // F.softplus
    const float A = -expf(a.a_log[h]);
    sm.dt[k] = dt;
    sm.da[k] = expf(__fmul_rn(dt, A));
    sm.dd[k] = a.d[h];
  }
  __syncthreads();

  float Bv[4], Cv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) Bv[j] = sm.B[lane_col + j], Cv[j] = sm.C[lane_col + j];
  T* out = static_cast<T*>(a.out) + static_cast<size_t>(b) * d_in;
  auto update = [&](float4(&v)[kRowsThread], int base) {
#pragma unroll
    for (int i = 0; i < kRowsThread; ++i) {
      const int row = base + i * kRowsPass + row_slot;
      float part = 0.f;
      if (row < rows) {
        const int k = row / HD;
        const float x = sm.x[row], dt = sm.dt[k], da = sm.da[k];
        const float dx = __fmul_rn(dt, x);
        float h[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          h[j] = __fadd_rn(__fmul_rn(da, h[j]), __fmul_rn(dx, Bv[j]));
        __stcs(reinterpret_cast<float4*>(state_row(row)),
               make_float4(h[0], h[1], h[2], h[3]));
        part = h[0] * Cv[0];
#pragma unroll
        for (int j = 1; j < 4; ++j) part = fmaf(h[j], Cv[j], part);
      }
#pragma unroll
      for (int off = kLanesRow / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (row < rows && tid % kLanesRow == 0) {
        const int k = row / HD, p = row % HD;
        const float y = __fadd_rn(part, __fmul_rn(sm.x[row], sm.dd[k]));
        out[head_of(k) * HD + p] = narrow<T>(y);
      }
    }
  };
  // two batches in registers: one loads while the other is updated
  for (int base = 0; base < rows; base += 2 * kRowsBatch) {
    load(vb, base + kRowsBatch);
    update(va, base);
    load(va, base + 2 * kRowsBatch);
    update(vb, base + kRowsBatch);
  }

  // every block has read the B and C window: block 0 shifts it
  cluster_wait();
  if (rank == 0) {
    for (int i = tid; i < 2 * DS; i += kThreads) {
      const int c = d_in + (i < DS ? g * DS + i : (a.ng + g) * DS + i - DS);
      for (int k = 0; k + 1 < k1; ++k)
        conv[static_cast<size_t>(k) * conv_dim + c] =
            conv[static_cast<size_t>(k + 1) * conv_dim + c];
      conv[static_cast<size_t>(k1 - 1) * conv_dim + c] = xbc[c];
    }
  }
}

int cluster_for(int rep) {
  int c = 1;
  while (c * 2 <= kMaxCluster && c * 2 <= rep) c *= 2;
  return c;
}

template <typename T, int DS, int HD>
cudaError_t launch(const Args& args, int b, cudaStream_t stream) {
  // clusters of 16 blocks are allowed on sm_90, not promised elsewhere
  cudaError_t err = cudaFuncSetAttribute(
      ssm_decode_kernel<T, DS, HD>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(args.cluster, args.ng, b);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_floats<DS, HD>(args.heads_max) * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = args.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ssm_decode_kernel<T, DS, HD>, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One instance a (d_state, head_dim) the port's configurations use: 16 and
// 128, 16 and 64.
template <typename T>
cudaError_t by_shape(const Args& args, int ds, int hd, int b,
                     cudaStream_t stream) {
  if (ds == 16 && hd == 16) return launch<T, 16, 16>(args, b, stream);
  if (ds == 16 && hd == 64) return launch<T, 16, 64>(args, b, stream);
  if (ds == 128 && hd == 16) return launch<T, 128, 16>(args, b, stream);
  if (ds == 128 && hd == 64) return launch<T, 128, 64>(args, b, stream);
  return cudaErrorInvalidValue;
}

size_t smem_bytes(int ds, int hd, int heads_max) {
  if (ds == 16 && hd == 16) return smem_floats<16, 16>(heads_max) * 4;
  if (ds == 16 && hd == 64) return smem_floats<16, 64>(heads_max) * 4;
  if (ds == 128 && hd == 16) return smem_floats<128, 16>(heads_max) * 4;
  if (ds == 128 && hd == 64) return smem_floats<128, 64>(heads_max) * 4;
  return 0;
}

// The cluster size a launch at these shapes takes, and the shared memory a
// block (bytes); 0 for shapes the kernel does not take.  ssm_decode.py's
// _check refuses the same shapes before a launch.
int plan(int nh, int ng, int ds, int hd, size_t* smem) {
  if (nh <= 0 || ng <= 0 || nh % ng) return 0;
  const int c = cluster_for(nh / ng);
  *smem = smem_bytes(ds, hd, (nh / ng + c - 1) / c);
  return *smem == 0 || *smem > kMaxSmem ? 0 : c;
}

}  // namespace

extern "C" {

const char* ssm_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xbc (b, conv_dim) and dt_raw (b, nh), rows xbc_stride and dt_stride
// elements apart, in type (0 fp32, 1 bf16); conv (b, d_conv - 1, conv_dim)
// contiguous in type and state (b, nh, hd, ds) contiguous fp32, both
// updated in place; conv_w (d_conv, conv_dim) and conv_b (conv_dim,) in
// type; dt_bias, a_log and d (nh,) fp32.  Writes out (b, nh * hd) in type.
int ssm_decode_fwd(int type, int ds, int hd, const void* xbc, long xbc_stride,
                   const void* dt_raw, long dt_stride, void* conv,
                   void* state, const void* conv_w, const void* conv_b,
                   const void* dt_bias, const void* a_log, const void* d,
                   void* out, int b, int nh, int ng, int d_conv,
                   void* stream) {
  size_t smem = 0;
  const int c = plan(nh, ng, ds, hd, &smem);
  if (c == 0 || (type != kF32 && type != kBF16) || b <= 0 || b > 65535 ||
      ng > 65535 || d_conv < 2 || d_conv > kMaxConv)
    return cudaErrorInvalidValue;
  Args args{};
  args.xbc = xbc, args.dt_raw = dt_raw, args.conv = conv;
  args.state = static_cast<float*>(state);
  args.conv_w = conv_w, args.conv_b = conv_b;
  args.dt_bias = static_cast<const float*>(dt_bias);
  args.a_log = static_cast<const float*>(a_log);
  args.d = static_cast<const float*>(d);
  args.out = out;
  args.xbc_stride = xbc_stride, args.dt_stride = dt_stride;
  args.nh = nh, args.ng = ng, args.d_conv = d_conv, args.cluster = c;
  args.heads_max = (nh / ng + c - 1) / c;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return type == kBF16 ? by_shape<__nv_bfloat16>(args, ds, hd, b, st)
                       : by_shape<float>(args, ds, hd, b, st);
}

}  // extern "C"
