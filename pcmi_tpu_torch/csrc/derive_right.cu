// K3 derive_right: the right-view cost volume from the left one,
//   out[i, y, x] = vol[i, y, x + d_min + i * stride]   (fill out of range)
//
// Replaces: pcmi_tpu/ops/stereo/pallas_kernels.py, derive_right_pallas /
// _make_derive_kernel (a double-buffered HBM->VMEM->HBM copy pipe whose
// input offset walks the disparity shift, with 128-lane-aligned windows).
//
// What bounds it: pure data movement, one read and one write of the volume
// (2 x D*H*W*4 bytes). One thread per output element, threads across x, so
// both the (shifted, contiguous) read and the write of a warp cover 128
// consecutive bytes; no alignment constraint applies on this card, so the
// shift is taken directly in the address. A copy: bit-exact.

#include <cuda_runtime.h>

namespace {

__global__ void derive_right_kernel(const float* __restrict__ vol,
                                    float* __restrict__ out, int H, int W,
                                    int d_min, int stride, float fill) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int i = blockIdx.z;
  if (x >= W) return;
  const long long row = ((long long)i * H + y) * W;
  const int xs = x + d_min + i * stride;
  out[row + x] = (xs >= 0 && xs < W) ? vol[row + xs] : fill;
}

}  // namespace

// vol, out: (D, H, W) float32 contiguous. Returns a cudaError_t.
extern "C" int pcmi_derive_right(const float* vol, float* out, int D, int H,
                                 int W, int d_min, int stride, float fill,
                                 void* stream) {
  if (D < 1 || H < 1 || W < 1 || D > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const dim3 grid((W + threads - 1) / threads, H, D);
  derive_right_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      vol, out, H, W, d_min, stride, fill);
  return (int)cudaGetLastError();
}
