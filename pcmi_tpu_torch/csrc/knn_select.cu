// K8 knn_select: for every query point the k + 1 smallest squared
// distances to a set of candidate points, in ascending order, without the
// (queries x candidates) distance block.
//
// Replaces: no TPU kernel. The reference's kNN outlier mask
// (pcmi_tpu/ops/pointcloud.py, knn_mean_distance) is a chunked XLA matmul
// and lax.top_k; the port's plain version (ops/pointcloud
// .knn_select_plain) writes a chunk x N float32 block per chunk of queries,
// makes five passes over it (the product's epilogue, the norms, the clamp,
// the mask) and a radix top-k.
//
// What it computes, value for value: the plain version's squared distance
// is ((a.b * -2 + |a|^2) + |b|^2), clamped at 0 (NaN kept), plus 0 for a
// valid candidate or +inf for an invalid one. Here the candidates come
// packed as (-2x, -2y, -2z, |b|^2 + mask) (ops/pointcloud.knn_select
// makes them with PyTorch's own operations), and the distance is
//   fma(az, -2bz, fma(ay, -2by, ax * -2bx)) + |a|^2 + (|b|^2 + mask),
// each operation rounded to float32 (-fmad=false, and the intrinsics say
// so). The dot product takes the order of cuBLAS's float32 kernel for the
// K = 3 product; scaling one factor by -2 commutes with every rounding
// (outside the subnormal range), and adding the mask to |b|^2 first gives
// the plain version's +inf or NaN (it differs only where a.b overflows
// float32). The k + 1 smallest values form one multiset whatever the order
// of ties, so the output is the plain version's, bit for bit, wherever
// cuBLAS takes its tiled GEMM (sm80_xmma_gemm_f32f32..._ffma for 2,048-row
// chunks: all of the fuse request's); it gives a one-row chunk to a gemv
// and tiny products to other kernels, which round the dot product in
// another order.
//
// Order: the values are all >= 0, +inf or NaN (the card's arithmetic gives
// the one canonical NaN 0x7fffffff), so their bits read as signed ints
// order them as torch.topk does (finite < +inf < NaN). A negative value
// (a rounding below 0 that the clamp lifts) reads as a negative int, below
// every kept value: it enters the list, clamped to 0, where 0 can enter.
//
// Design: the selection is compute-bound: 6 instructions per (query,
// candidate) evaluation (the dot product's three, two adds, one compare),
// 1.07e11 evaluations at 327,680 points, 19.2 ms at the card's float32
// rate (132 SMs x 128 lanes x 1.98 GHz). So:
//   - each thread owns Q queries (template: 1, 2 or 4): their coordinates,
//     |a|^2 and a sorted list of CAP keys (template: 2, 4, 8, 16 or 32 >=
//     k + 1) in registers. The list's first CAP - (k + 1) slots hold
//     INT_MIN and never move, so the worst kept key is always the last
//     slot, a compile-time register; an insertion is 2 CAP min/max;
//   - candidates stream through shared memory in tiles of kTile packed
//     float4, two tiles in flight by cp.async; every thread of the block
//     reads the same word (a broadcast), and each read serves Q queries;
//   - the hot loop computes kGroup candidates for every query and only
//     ORs "below the worst" into one predicate (6.9 instructions an
//     evaluation at Q = 2 in the compiled loop); in the rare group that
//     sets it for some lane of the warp, the group is computed again with
//     the insertions (a query takes about k ln(N / k) in random order).
//     The compare against the group's first worst can only over-report,
//     never miss. A branch per candidate instead measured 13 % slower;
//   - one block takes kThreads x Q queries against every candidate, so a
//     launch has one block per query tile: 1,280 blocks at 327,680
//     points, ~10 a SM. Splitting the candidates over several blocks a
//     tile measured slower at that size (each split fills its lists anew,
//     which costs insertions), and saved under 1 ms a call at the sizes
//     where it helped, below ~135k points (two fused pairs or fewer).
// At 327,680 points, k = 8 (Q = 2): 34.7-34.9 ms by CUDA events
// on an H100 at 700 W, 55 % of the bound; the plain version ~3,000 ms.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kTile = 256;     // candidates per shared-memory tile
constexpr int kGroup = 8;      // candidates per predicate check
constexpr int kMaxK1 = 32;     // the longest list, k + 1

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The plain version's squared distance with -2 folded into the candidate
// and the mask into its norm (above), as the bits of a float.
__device__ __forceinline__ int dist_key(float x, float y, float z, float an,
                                        float4 c) {
  float d = __fmul_rn(x, c.x);
  d = __fmaf_rn(y, c.y, d);
  d = __fmaf_rn(z, c.z, d);
  return __float_as_int(__fadd_rn(__fadd_rn(d, an), c.w));
}

// Insert v (>= 0) into the ascending list L, dropping its largest key.
template <int CAP>
__device__ __forceinline__ void insert(int (&L)[CAP], int v) {
#pragma unroll
  for (int i = CAP - 1; i > 0; --i) L[i] = max(L[i - 1], min(L[i], v));
  L[0] = min(L[0], v);
}

// The last k1 slots of L (the kept keys, ascending) as floats at dst.
template <int CAP>
__device__ __forceinline__ void store_list(const int (&L)[CAP], int k1,
                                           float* dst) {
#pragma unroll
  for (int i = 0; i < CAP; ++i)
    if (i >= CAP - k1) dst[i - (CAP - k1)] = __int_as_float(L[i]);
}

struct Args {
  const float* queries;  // (M, 3)
  const float* qnorm;    // (M,) |a|^2
  const float4* cands;   // (N,) (-2x, -2y, -2z, |b|^2 + mask)
  int M, N, k1;
  float* out;            // (M, k1)
};

template <int CAP, int Q>
__global__ void __launch_bounds__(kThreads)
    knn_select_kernel(const Args a) {
  __shared__ float4 buf[2][kTile];
  const int tid = threadIdx.x;
  const long long q0 = (long long)blockIdx.x * kThreads * Q + tid;

  float qx[Q], qy[Q], qz[Q], qn[Q];
  int L[Q][CAP];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const long long q = min(q0 + (long long)j * kThreads, (long long)a.M - 1);
    qx[j] = a.queries[3 * q];
    qy[j] = a.queries[3 * q + 1];
    qz[j] = a.queries[3 * q + 2];
    qn[j] = a.qnorm[q];
#pragma unroll
    for (int i = 0; i < CAP; ++i) L[j][i] = i < CAP - a.k1 ? INT_MIN : INT_MAX;
  }

  const int tiles = (a.N + kTile - 1) / kTile;
  // a tile's slots past N hold a candidate whose distance is NaN: its key
  // INT_MAX is never below the worst
  auto load = [&](int t) {
    float4* dst = buf[t & 1];
    const int base = t * kTile;
    for (int i = tid; i < kTile; i += kThreads) {
      if (base + i < a.N)
        cp_async16(dst + i, a.cands + base + i);
      else
        dst[i] = make_float4(0.f, 0.f, 0.f, __int_as_float(0x7fffffff));
    }
    cp_async_commit();
  };

  load(0);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      load(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* b = buf[t & 1];
#pragma unroll 1
    for (int g = 0; g < kTile; g += kGroup) {
      bool hit = false;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float4 c = b[g + u];
#pragma unroll
        for (int j = 0; j < Q; ++j)
          hit |= dist_key(qx[j], qy[j], qz[j], qn[j], c) < L[j][CAP - 1];
      }
      if (hit) {
#pragma unroll 1
        for (int u = 0; u < kGroup; ++u) {
          const float4 c = b[g + u];
#pragma unroll
          for (int j = 0; j < Q; ++j) {
            const int key = dist_key(qx[j], qy[j], qz[j], qn[j], c);
            if (key < L[j][CAP - 1]) insert(L[j], max(key, 0));
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const long long q = q0 + (long long)j * kThreads;
    if (q < a.M) store_list(L[j], a.k1, a.out + q * a.k1);
  }
}

template <int CAP>
cudaError_t launch_cap(const Args& a, int q_per_thread, unsigned grid,
                       cudaStream_t st) {
  switch (q_per_thread) {
    case 1:
      knn_select_kernel<CAP, 1><<<grid, kThreads, 0, st>>>(a);
      break;
    case 2:
      knn_select_kernel<CAP, 2><<<grid, kThreads, 0, st>>>(a);
      break;
    case 4:
      knn_select_kernel<CAP, 4><<<grid, kThreads, 0, st>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// queries: (M, 3) float32; qnorm: (M,) float32 |a|^2; cands: (N, 4)
// float32 (-2x, -2y, -2z, |b|^2 + mask), 16-byte aligned; out: (M, k1)
// float32, ascending. The launch plan (knn_select_plan in
// ops/stereo/kernels.py): lists of `cap` keys (a power of two from 2 to
// 32, >= k1), `q_per_thread` queries a thread (1, 2 or 4). Returns a
// cudaError_t.
extern "C" int pcmi_knn_select(const void* queries, const void* qnorm, int M,
                               const void* cands, int N, int k1, int cap,
                               int q_per_thread, void* out, void* stream) {
  if (M < 1 || N < 1 || k1 < 1 || k1 > kMaxK1 || k1 > cap || k1 > N ||
      reinterpret_cast<size_t>(cands) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      ((long long)M + kThreads * q_per_thread - 1) / (kThreads * q_per_thread);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const Args a = {static_cast<const float*>(queries),
                  static_cast<const float*>(qnorm),
                  static_cast<const float4*>(cands),
                  M, N, k1, static_cast<float*>(out)};
  const unsigned grid = (unsigned)tiles;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (cap) {
    case 2: return (int)launch_cap<2>(a, q_per_thread, grid, st);
    case 4: return (int)launch_cap<4>(a, q_per_thread, grid, st);
    case 8: return (int)launch_cap<8>(a, q_per_thread, grid, st);
    case 16: return (int)launch_cap<16>(a, q_per_thread, grid, st);
    case 32: return (int)launch_cap<32>(a, q_per_thread, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
