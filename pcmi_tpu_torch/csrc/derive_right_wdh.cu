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
// (2 x Wp*Dp*Hp elements of 4 or 2 bytes). One thread per output element,
// threads along y, so each warp reads and writes 128 consecutive bytes (64
// in bfloat16); the shift rides the major axis and goes straight into the
// address. A copy: bit-exact. The kernel is blind to the element type but
// for its three constants: `fill`, 1e9 and 0 arrive in the stored type
// (1e9 is 998244352 and 1e4 is 9984 in bfloat16), as the TPU kernel casts
// them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;

template <typename E>
__global__ void derive_right_wdh_kernel(const E* __restrict__ vol,
                                        E* __restrict__ out, int Dp,
                                        int Hp, int d_real, int w, int d_min,
                                        int stride, E fill, E big, E zero) {
  const int y = blockIdx.x * blockDim.x + threadIdx.x;
  const int d = blockIdx.y;
  const int x = blockIdx.z;
  if (y >= Hp) return;
  E v;
  if (x >= w) {
    v = zero;
  } else if (d >= d_real) {
    v = big;
  } else {
    const int xs = x + d_min + d * stride;
    v = (xs >= 0 && xs < w) ? vol[((long long)xs * Dp + d) * Hp + y] : fill;
  }
  out[((long long)x * Dp + d) * Hp + y] = v;
}

}  // namespace

// vol, out: (Wp, Dp, Hp) float32, or bfloat16 with bf16 != 0, contiguous;
// d_real <= Dp and w <= Wp are
// the real disparity count and image width. Returns a cudaError_t.
extern "C" int pcmi_derive_right_wdh(const void* vol, void* out, int Wp,
                                     int Dp, int Hp, int d_real, int w,
                                     int d_min, int stride, float fill,
                                     int bf16, void* stream) {
  if (Wp < 1 || Dp < 1 || Hp < 1 || Wp > 65535 || Dp > 65535 ||
      d_real < 1 || d_real > Dp || w < 1 || w > Wp)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const dim3 grid((Hp + threads - 1) / threads, Dp, Wp);
  if (bf16)
    derive_right_wdh_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(vol),
        static_cast<__nv_bfloat16*>(out), Dp, Hp, d_real, w, d_min, stride,
        __float2bfloat16_rn(fill), __float2bfloat16_rn(kBig),
        __float2bfloat16_rn(0.f));
  else
    derive_right_wdh_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(vol), static_cast<float*>(out), Dp, Hp,
        d_real, w, d_min, stride, fill, kBig, 0.f);
  return (int)cudaGetLastError();
}
