// K4 sgm_hwd: one semi-global aggregation direction over an (H, W, D)
// float32 cost volume, disparities on the fast axis.
//
// Replaces: pcmi_tpu/ops/stereo/pallas_kernels.py, _dir_call /
// _make_dir_kernel / _step (the TPU kernel streams (band, chunk, Dp) blocks
// of a volume padded to 128 disparity lanes through VMEM and scans the
// horizontal paths on a swapaxes copy). This kernel reads (H, W, D) in
// place and scans either axis directly; D bounds are index checks, so no
// padding is needed (the TPU's BIG disparity padding and zero spatial
// padding both wash out of the result).
//
// Recurrence and grouping as K1 (csrc/sgm_dir.cu):
//   best = min(min(L'(d), m + P2), min(L'(d-1) + P1, L'(d+1) + P1))
//   L(d) = (C(d) + best) - m,     m = min_d L'(d)
// Only adds and mins: with -fmad=false the result is bit-identical to the
// plain PyTorch version (kernels.sgm_hwd_plain).
//
// What bounds it: a scan step depends on the previous one, so each path is
// sequential. One warp per path: lane l holds disparities l, l + 32, ...
// in registers, the min over D is a five-step xor-shuffle reduction and
// the d-1 / d+1 neighbours are __shfl_up/__shfl_down plus the register of
// the next lane group across the lane 0 / lane 31 seam. A step reads the D
// contiguous costs of its path, so both scan axes coalesce (D x 4 bytes
// per warp and step); the next step's costs are loaded before the current
// step is computed. The card holds only H or W paths (896 warps at the
// headline), a few warps per SM: the kernel is bound by the latency of
// the per-step load and reduction chain, not by bandwidth.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kMaxPer = 16;    // disparities per lane: D <= 512
constexpr float kBig = 1e9f;   // the reference's no-neighbour value
constexpr unsigned kFull = 0xffffffffu;

__global__ void sgm_hwd_kernel(const float* __restrict__ cost,
                               float* __restrict__ out, int D, int S,
                               int span, long long sS, long long sL,
                               float p1, float p2, int reverse,
                               int accumulate) {
  const int lane = threadIdx.x;
  const int path = blockIdx.x;
  if (path >= span) return;  // the whole warp leaves together
  const int nper = (D + 31) >> 5;
  const long long base = (long long)path * sL;

  float prev[kMaxPer], cn[kMaxPer], on[kMaxPer];
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) prev[k] = 0.f;

  auto load = [&](int s) {
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      const int d = lane + 32 * k;
      cn[k] = 0.f;
      on[k] = 0.f;
      if (k < nper && d < D) {
        const long long o = base + s * sS + d;
        cn[k] = cost[o];
        if (accumulate) on[k] = out[o];
      }
    }
  };
  load(reverse ? S - 1 : 0);

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
    const long long row = base + s * sS;
    float nxt[kMaxPer];
    float local = FLT_MAX;
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      nxt[k] = prev[k];
      if (k < nper) {  // uniform across the warp: shuffles stay converged
        const int d = lane + 32 * k;
        float pu = __shfl_up_sync(kFull, prev[k], 1);
        const float seam_u = __shfl_sync(kFull, prev[k > 0 ? k - 1 : 0], 31);
        if (lane == 0) pu = seam_u;
        float pd = __shfl_down_sync(kFull, prev[k], 1);
        const float seam_d =
            __shfl_sync(kFull, prev[k + 1 < kMaxPer ? k + 1 : k], 0);
        if (lane == 31) pd = seam_d;
        if (d == 0) pu = kBig;
        if (d + 1 >= D) pd = kBig;
        const float best =
            fminf(fminf(prev[k], mp2), fminf(pu + p1, pd + p1));
        const float v = (c[k] + best) - m;
        nxt[k] = v;
        if (d < D) {
          local = fminf(local, v);
          out[row + d] = accumulate ? o_old[k] + v : v;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) prev[k] = nxt[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      local = fminf(local, __shfl_xor_sync(kFull, local, off));
    m = local;
  }
}

}  // namespace

extern "C" int pcmi_sgm_hwd_max_disp() { return 32 * kMaxPer; }

// cost, out: (H, W, D) float32, contiguous, on the current device.
// scan_axis 0 scans H (T->B, or B->T with reverse; paths are columns),
// 1 scans W (L->R, or R->L; paths are rows). accumulate != 0 adds the
// direction into `out` (out = out + L) instead of storing it. Returns a
// cudaError_t.
extern "C" int pcmi_sgm_hwd(const float* cost, float* out, int H, int W,
                            int D, int scan_axis, int reverse,
                            int accumulate, float p1, float p2,
                            void* stream) {
  if (D < 1 || D > 32 * kMaxPer || H < 1 || W < 1 ||
      (scan_axis != 0 && scan_axis != 1))
    return (int)cudaErrorInvalidValue;
  const long long rowW = (long long)W * D;
  const int S = scan_axis == 0 ? H : W;
  const int span = scan_axis == 0 ? W : H;
  const long long sS = scan_axis == 0 ? rowW : D;
  const long long sL = scan_axis == 0 ? D : rowW;
  sgm_hwd_kernel<<<span, 32, 0, (cudaStream_t)stream>>>(
      cost, out, D, S, span, sS, sL, p1, p2, reverse, accumulate);
  return (int)cudaGetLastError();
}
