// K1 sgm_dir: one semi-global aggregation direction over a (D, H, W)
// float32 cost volume.
//
// Replaces: pcmi_tpu/ops/stereo/pallas_kernels.py, _dir_call_sub /
// _make_dir_kernel_sub / _step_sub (the TPU kernel scans an (S, Dp, B)
// transposed copy of the volume; this kernel reads (D, H, W) in place).
//
// Recurrence (Hirschmueller 2008), state zero at the path start, float32:
//   L(p, d) = C(p, d) + min(L'(d), L'(d-1) + P1, L'(d+1) + P1, min L' + P2)
//             - min L'
// with "no neighbour" (1e9, as the reference's BIG padding) outside [0, D).
// Only adds and mins: with -fmad=false the result is bit-identical to the
// plain PyTorch version (kernels.sgm_dir_plain).
//
// accumulate != 0 adds the direction into `out` (out = out + L) instead of
// storing it, so lr + rl and tb + bt each land in one volume with the
// reference's add grouping.
//
// What bounds it: a scan step depends on the previous one, so each path is
// sequential in S; the volume is read once and written once per direction
// (2 x D*H*W*4 bytes, 3x with accumulate). A block holds kLanes
// neighbouring paths and spreads the D disparities over kGroups thread
// groups; the per-step min over D is a warp shuffle plus one shared-memory
// pass, and the state lives in shared memory, double-buffered, so a step
// needs one __syncthreads. The next step's costs are loaded before the
// current step is computed. Vertical paths (T->B, B->T) read kLanes
// consecutive x per disparity: 32-byte sectors, fully used. Horizontal
// paths read one element per row per step; the other seven elements of
// each sector are used by the following steps through L1/L2, not through
// coalescing (the layout question is in ROADMAP.md).

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kLanes = 8;      // paths per block
constexpr int kGroups = 32;    // disparity groups per block
constexpr int kMaxPer = 16;    // disparities per thread: D <= 512
constexpr int kWarps = kLanes * kGroups / 32;
constexpr float kBig = 1e9f;   // the reference's no-neighbour value

__global__ void sgm_dir_kernel(const float* __restrict__ cost,
                               float* __restrict__ out, int D, int S,
                               int span, long long sD, long long sS,
                               long long sL, float p1, float p2, int reverse,
                               int accumulate) {
  extern __shared__ float smem[];
  float* prev = smem;                       // [D][kLanes]
  float* cur = smem + D * kLanes;           // [D][kLanes]
  float* red = smem + 2 * D * kLanes;       // [2][kWarps][kLanes]

  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int warp = (g * kLanes + lane) / 32;
  const int path = blockIdx.x * kLanes + lane;
  const bool active = path < span;
  const long long base = active ? (long long)path * sL : 0;

  for (int d = g; d < D; d += kGroups) prev[d * kLanes + lane] = 0.f;

  float cn[kMaxPer], on[kMaxPer];
  auto load = [&](int s) {
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      const int d = g + k * kGroups;
      cn[k] = 0.f;
      on[k] = 0.f;
      if (active && d < D) {
        const long long o = d * sD + s * sS + base;
        cn[k] = cost[o];
        if (accumulate) on[k] = out[o];
      }
    }
  };
  load(reverse ? S - 1 : 0);
  __syncthreads();

  float m = 0.f;
  for (int t = 0; t < S; ++t) {
    const int s = reverse ? S - 1 - t : t;
    float c[kMaxPer], o_old[kMaxPer];
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      c[k] = cn[k];
      o_old[k] = on[k];
    }
    if (t + 1 < S) load(reverse ? s - 1 : s + 1);

    const float mp2 = m + p2;
    float local = FLT_MAX;
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      const int d = g + k * kGroups;
      if (d < D) {
        const float pp = prev[d * kLanes + lane];
        const float pu = d > 0 ? prev[(d - 1) * kLanes + lane] : kBig;
        const float pd = d < D - 1 ? prev[(d + 1) * kLanes + lane] : kBig;
        const float best = fminf(fminf(pp, mp2), fminf(pu + p1, pd + p1));
        const float v = (c[k] + best) - m;
        cur[d * kLanes + lane] = v;
        local = fminf(local, v);
        if (active) {
          const long long o = d * sD + s * sS + base;
          out[o] = accumulate ? o_old[k] + v : v;
        }
      }
    }
    // min over the four disparity groups of this warp that share a lane
    local = fminf(local, __shfl_xor_sync(0xffffffffu, local, 8));
    local = fminf(local, __shfl_xor_sync(0xffffffffu, local, 16));
    float* r = red + (t & 1) * kWarps * kLanes;
    if ((g & 3) == 0) r[warp * kLanes + lane] = local;
    __syncthreads();
    m = r[lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fminf(m, r[w * kLanes + lane]);
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
}

}  // namespace

extern "C" int pcmi_sgm_dir_max_disp() { return kMaxPer * kGroups; }

// cost, out: (D, H, W) float32, contiguous, on the current device.
// horizontal != 0 scans along W (L->R, or R->L with reverse), else along H
// (T->B, or B->T with reverse). Returns a cudaError_t.
extern "C" int pcmi_sgm_dir(const float* cost, float* out, int D, int H,
                            int W, int horizontal, int reverse,
                            int accumulate, float p1, float p2,
                            void* stream) {
  if (D < 1 || D > kMaxPer * kGroups || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const long long sD = (long long)H * W;
  const int S = horizontal ? W : H;
  const int span = horizontal ? H : W;
  const long long sS = horizontal ? 1 : W;
  const long long sL = horizontal ? W : 1;
  const dim3 block(kLanes, kGroups);
  const dim3 grid((span + kLanes - 1) / kLanes);
  const size_t smem = (size_t)(2 * D * kLanes + 2 * kWarps * kLanes) *
                      sizeof(float);
  sgm_dir_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      cost, out, D, S, span, sD, sS, sL, p1, p2, reverse, accumulate);
  return (int)cudaGetLastError();
}
