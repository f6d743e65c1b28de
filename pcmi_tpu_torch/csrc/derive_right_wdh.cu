// K6 derive_right_wdh: the right-view cost volume from the left one, in
// the padded (Wp, Dp, Hp) scan layout,
//   out[x, d, y] = vol[x + d_min + d * stride, d, y]   for x < w, d < d_real
//                  fill   where the source column lies outside [0, w)
//                  1e9    for padded disparities d >= d_real
//                  0      for padded columns x >= w (this rule wins, also
//                         for padded d, as in the reference)
//
// Replaces: pcmi_tpu/ops/stereo/pallas_kernels.py, derive_right_wdh_pallas
// / _make_derive_wdh_kernel (strided HBM->VMEM->HBM copies of 8-disparity
// groups along the major axis, with where-masks for the out-of-image tails,
// in W segments sized to fit VMEM).
//
// What bounds it: pure data movement, one read and one write of the volume
// (2 x Wp*Dp*Hp*4 bytes). One thread per output element, threads along y,
// so each warp reads and writes 128 consecutive bytes; the shift rides the
// major axis and goes straight into the address. A copy: bit-exact.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;

__global__ void derive_right_wdh_kernel(const float* __restrict__ vol,
                                        float* __restrict__ out, int Dp,
                                        int Hp, int d_real, int w, int d_min,
                                        int stride, float fill) {
  const int y = blockIdx.x * blockDim.x + threadIdx.x;
  const int d = blockIdx.y;
  const int x = blockIdx.z;
  if (y >= Hp) return;
  float v;
  if (x >= w) {
    v = 0.f;
  } else if (d >= d_real) {
    v = kBig;
  } else {
    const int xs = x + d_min + d * stride;
    v = (xs >= 0 && xs < w) ? vol[((long long)xs * Dp + d) * Hp + y] : fill;
  }
  out[((long long)x * Dp + d) * Hp + y] = v;
}

}  // namespace

// vol, out: (Wp, Dp, Hp) float32 contiguous; d_real <= Dp and w <= Wp are
// the real disparity count and image width. Returns a cudaError_t.
extern "C" int pcmi_derive_right_wdh(const float* vol, float* out, int Wp,
                                     int Dp, int Hp, int d_real, int w,
                                     int d_min, int stride, float fill,
                                     void* stream) {
  if (Wp < 1 || Dp < 1 || Hp < 1 || Wp > 65535 || Dp > 65535 ||
      d_real < 1 || d_real > Dp || w < 1 || w > Wp)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const dim3 grid((Hp + threads - 1) / threads, Dp, Wp);
  derive_right_wdh_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      vol, out, Dp, Hp, d_real, w, d_min, stride, fill);
  return (int)cudaGetLastError();
}
