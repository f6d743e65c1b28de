// K2 wta: combine one or two (D, H, W) float32 aggregates and take the
// winner-takes-all disparity, its cost and its uniqueness margin.
//
// Replaces three TPU kernels in pcmi_tpu/ops/stereo/pallas_kernels.py:
//   sgm4_wta_fused_pallas / _make_wta3_kernel   left view, (a + b) * 0.25,
//       and with_aggregate: the combined aggregate s itself as an output
//   right_disparity_fused_pallas / _make_wta2_kernel   right view argmin
//   wta_fused_pallas / _make_wta_kernel   the cross-checker's WTA
// and follows the XLA form of matching.wta_disparity, which the CPU
// reference runs:
//   s_d    = (a_d + b_d) * scale   (or a_d * scale with one input)
//   idx    = first argmin_d s_d;  best = s_idx
//   denom  = (prev - 2 * best) + next   (prev/next = s_{idx-1}, s_{idx+1})
//   off    = 0.5 * (prev - next) / max(denom, 1e-9) if 0 < idx < D-1 and
//            denom > 1e-9, else 0; clipped to [-1, 1]
//   disp   = d_min + stride * (idx + off)
//   margin = min_{|d - idx| > 1} s_d - best   (1e9 - best if no such d)
// Costs must lie below 1e9 (the reference's BIG), as every volume the
// matcher builds does.
//
// With agg_out the kernel also stores s_d to agg_out[d, y, x] ((D, H, W),
// where the TPU kernel keeps its padded (W, Dp, H) scan layout): the right
// view of right_sgm="diagonal" is then one diagonal argmin over that
// volume (matching.diag_right_disparity).
//
// What bounds it: one read of each input volume (D*H*W*4 bytes per input);
// the outputs are three (H, W) planes, and with agg_out one volume more,
// written in the same walk. One thread per pixel walks D, so
// the threads of a warp read 32 consecutive x of one disparity slice
// (128-byte transactions). A running sorted top-4 with indices gives the
// margin in the same pass (the best's two neighbours can hold at most two
// of the four slots), and the best's neighbours are tracked as the walk
// passes them, so the volume is read once.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;

__global__ void wta_kernel(const float* __restrict__ a,
                           const float* __restrict__ b, int D, long long HW,
                           float scale, float d_min, float stride,
                           int subpixel, float* __restrict__ disp,
                           float* __restrict__ best_out,
                           float* __restrict__ margin_out,
                           float* __restrict__ agg_out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  float v1 = kBig, v2 = kBig, v3 = kBig, v4 = kBig;
  int i1 = -8, i2 = -8, i3 = -8, i4 = -8;
  float prev = kBig, next = kBig, last = kBig;
  for (int d = 0; d < D; ++d) {
    const long long o = (long long)d * HW + p;
    const float val = b ? (a[o] + b[o]) * scale : a[o] * scale;
    if (agg_out) agg_out[o] = val;
    const bool b1 = val < v1, b2 = val < v2, b3 = val < v3, b4 = val < v4;
    if (b1) {
      prev = last;
      next = kBig;
    } else if (d == i1 + 1) {
      next = val;
    }
    v4 = b3 ? v3 : (b4 ? val : v4);
    i4 = b3 ? i3 : (b4 ? d : i4);
    v3 = b2 ? v2 : (b3 ? val : v3);
    i3 = b2 ? i2 : (b3 ? d : i3);
    v2 = b1 ? v1 : (b2 ? val : v2);
    i2 = b1 ? i1 : (b2 ? d : i2);
    v1 = b1 ? val : v1;
    i1 = b1 ? d : i1;
    last = val;
  }
  float off = 0.f;
  if (subpixel) {
    const float denom = (prev - 2.f * v1) + next;
    if (denom > 1e-9f && i1 > 0 && i1 < D - 1)
      off = 0.5f * (prev - next) / fmaxf(denom, 1e-9f);
    off = fminf(fmaxf(off, -1.f), 1.f);
  }
  disp[p] = d_min + stride * ((float)i1 + off);
  best_out[p] = v1;
  if (margin_out) {
    const float second =
        abs(i2 - i1) > 1 ? v2 : (abs(i3 - i1) > 1 ? v3 : v4);
    margin_out[p] = second - v1;
  }
}

}  // namespace

// a, b: (D, H, W) float32 contiguous (b may be null); disp, best: (H, W);
// margin: (H, W) or null; agg: (D, H, W) or null. Returns a cudaError_t.
extern "C" int pcmi_wta(const float* a, const float* b, int D, int H, int W,
                        float scale, float d_min, float stride, int subpixel,
                        float* disp, float* best, float* margin, float* agg,
                        void* stream) {
  if (D < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const long long HW = (long long)H * W;
  const int threads = 256;
  const unsigned blocks = (unsigned)((HW + threads - 1) / threads);
  wta_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      a, b, D, HW, scale, d_min, stride, subpixel, disp, best, margin, agg);
  return (int)cudaGetLastError();
}
