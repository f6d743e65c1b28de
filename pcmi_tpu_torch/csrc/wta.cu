// K2 wta: combine one or two (D, H, W) float32 or bfloat16 aggregates and
// take the
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
// On bfloat16 volumes the combine is the TPU kernels' bfloat16 arithmetic:
// a_d + b_d is a bfloat16 add (widened, added, rounded to nearest-even),
// as `hsum = lr + rl` and `vert + hsum` are, and the product with `scale`
// a bfloat16 multiply. The scales the matcher uses (1, 0.5, 0.25) are
// powers of two and leave the rounded sum exact; another scale is itself
// rounded to bfloat16 first and the product rounded again, as a bfloat16
// multiply by a constant is. s_d is then widened: argmin, parabola, best
// and margin are float32 and go to float32 planes, and agg_out takes s_d
// as bfloat16.
//
// With agg_out the kernel also stores s_d to agg_out[d, y, x] ((D, H, W),
// where the TPU kernel keeps its padded (W, Dp, H) scan layout): the right
// view of right_sgm="diagonal" is then one diagonal argmin over that
// volume (matching.diag_right_disparity).
//
// What bounds it: one read of each input volume (D*H*W elements of 4 or 2
// bytes per input); the outputs are three (H, W) planes, and with agg_out
// one volume more, written in the same walk. One thread per pixel walks D,
// so the threads of a warp read 32 consecutive x of one disparity slice
// (128-byte transactions). In bfloat16 one thread walks two neighbouring
// pixels, one 32-bit load per input and slice, so a warp's transactions
// and the bytes each thread keeps in flight stay those of float32 (an odd
// H*W, whose slices are not 4-byte aligned, takes one pixel per thread). A
// running sorted top-4 with indices gives the margin in the same pass (the
// best's two neighbours can hold at most two of the four slots), and the
// best's neighbours are tracked as the walk passes them, so the volume is
// read once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float rounded(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bfloat16 s_d from widened inputs: `scale` arrives rounded to bfloat16
__device__ __forceinline__ float combine16(float a, float b, bool two,
                                           float scale) {
  return rounded((two ? rounded(a + b) : a) * scale);
}

__device__ __forceinline__ float lo_of(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_of(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// s_d of kPix neighbouring pixels from offset o, and its store into agg
template <int kPix>
__device__ __forceinline__ void combine(const float* a, const float* b,
                                        long long o, float scale,
                                        float (&val)[kPix]) {
  static_assert(kPix == 1, "float32 walks one pixel per thread");
  val[0] = b ? (a[o] + b[o]) * scale : a[o] * scale;
}
template <int kPix>
__device__ __forceinline__ void combine(const bf16* a, const bf16* b,
                                        long long o, float scale,
                                        float (&val)[kPix]) {
  if (kPix == 1) {
    val[0] = combine16(__bfloat162float(a[o]),
                       b ? __bfloat162float(b[o]) : 0.f, b != nullptr, scale);
  } else {
    const unsigned ua = *reinterpret_cast<const unsigned*>(a + o);
    const unsigned ub = b ? *reinterpret_cast<const unsigned*>(b + o) : 0u;
    val[0] = combine16(lo_of(ua), lo_of(ub), b != nullptr, scale);
    val[kPix - 1] = combine16(hi_of(ua), hi_of(ub), b != nullptr, scale);
  }
}

template <int kPix>
__device__ __forceinline__ void put(float* p, const float (&val)[kPix]) {
  *p = val[0];
}
template <int kPix>
__device__ __forceinline__ void put(bf16* p, const float (&val)[kPix]) {
  if (kPix == 1) {
    *p = __float2bfloat16_rn(val[0]);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(val[0], val[kPix - 1]);
    *reinterpret_cast<__nv_bfloat162*>(p) = v;
  }
}

// One thread walks D for kPix neighbouring pixels (kPix > 1: H*W a multiple
// of kPix and 4-byte aligned volumes).
template <typename E, int kPix>
__global__ void wta_kernel(const E* __restrict__ a,
                           const E* __restrict__ b, int D, long long HW,
                           float scale, float d_min, float stride,
                           int subpixel, float* __restrict__ disp,
                           float* __restrict__ best_out,
                           float* __restrict__ margin_out,
                           E* __restrict__ agg_out) {
  const long long p =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kPix;
  if (p >= HW) return;
  float v1[kPix], v2[kPix], v3[kPix], v4[kPix];
  int i1[kPix], i2[kPix], i3[kPix], i4[kPix];
  float prev[kPix], next[kPix], last[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    v1[q] = v2[q] = v3[q] = v4[q] = kBig;
    i1[q] = i2[q] = i3[q] = i4[q] = -8;
    prev[q] = next[q] = last[q] = kBig;
  }
  for (int d = 0; d < D; ++d) {
    const long long o = (long long)d * HW + p;
    float vals[kPix];
    combine<kPix>(a, b, o, scale, vals);
    if (agg_out) put<kPix>(agg_out + o, vals);
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      const float val = vals[q];
      const bool b1 = val < v1[q], b2 = val < v2[q], b3 = val < v3[q],
                 b4 = val < v4[q];
      if (b1) {
        prev[q] = last[q];
        next[q] = kBig;
      } else if (d == i1[q] + 1) {
        next[q] = val;
      }
      v4[q] = b3 ? v3[q] : (b4 ? val : v4[q]);
      i4[q] = b3 ? i3[q] : (b4 ? d : i4[q]);
      v3[q] = b2 ? v2[q] : (b3 ? val : v3[q]);
      i3[q] = b2 ? i2[q] : (b3 ? d : i3[q]);
      v2[q] = b1 ? v1[q] : (b2 ? val : v2[q]);
      i2[q] = b1 ? i1[q] : (b2 ? d : i2[q]);
      v1[q] = b1 ? val : v1[q];
      i1[q] = b1 ? d : i1[q];
      last[q] = val;
    }
  }
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    float off = 0.f;
    if (subpixel) {
      const float denom = (prev[q] - 2.f * v1[q]) + next[q];
      if (denom > 1e-9f && i1[q] > 0 && i1[q] < D - 1)
        off = 0.5f * (prev[q] - next[q]) / fmaxf(denom, 1e-9f);
      off = fminf(fmaxf(off, -1.f), 1.f);
    }
    disp[p + q] = d_min + stride * ((float)i1[q] + off);
    best_out[p + q] = v1[q];
    if (margin_out) {
      const float second = abs(i2[q] - i1[q]) > 1
                               ? v2[q]
                               : (abs(i3[q] - i1[q]) > 1 ? v3[q] : v4[q]);
      margin_out[p + q] = second - v1[q];
    }
  }
}

template <typename E, int kPix>
void launch(const void* a, const void* b, int D, long long HW, float scale,
            float d_min, float stride, int subpixel, float* disp, float* best,
            float* margin, void* agg, cudaStream_t stream) {
  const int threads = 256;
  const long long n = HW / kPix;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  wta_kernel<E, kPix><<<blocks, threads, 0, stream>>>(
      static_cast<const E*>(a), static_cast<const E*>(b), D, HW, scale, d_min,
      stride, subpixel, disp, best, margin, static_cast<E*>(agg));
}

inline bool aligned4(const void* p) {
  return reinterpret_cast<size_t>(p) % 4 == 0;
}

}  // namespace

// a, b: (D, H, W) float32, or bfloat16 with bf16_in != 0, contiguous (b may
// be null); disp, best: (H, W) float32; margin: (H, W) float32 or null; agg:
// (D, H, W) of the inputs' type or null. Returns a cudaError_t.
extern "C" int pcmi_wta(const void* a, const void* b, int D, int H, int W,
                        float scale, float d_min, float stride, int subpixel,
                        float* disp, float* best, float* margin, void* agg,
                        int bf16_in, void* stream) {
  if (D < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const long long HW = (long long)H * W;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!bf16_in) {
    launch<float, 1>(a, b, D, HW, scale, d_min, stride, subpixel, disp, best,
                     margin, agg, s);
  } else {
    const float sc = __bfloat162float(__float2bfloat16_rn(scale));
    if (HW % 2 == 0 && aligned4(a) && aligned4(b) && aligned4(agg))
      launch<bf16, 2>(a, b, D, HW, sc, d_min, stride, subpixel, disp, best,
                      margin, agg, s);
    else
      launch<bf16, 1>(a, b, D, HW, sc, d_min, stride, subpixel, disp, best,
                      margin, agg, s);
  }
  return (int)cudaGetLastError();
}
