// K3 derive_right: the right-view cost volume from the left one,
//   out[i, y, x] = vol[i, y, x + d_min + i * stride]   (fill out of range)
//
// Replaces: pcmi_tpu/ops/stereo/pallas_kernels.py, derive_right_pallas /
// _make_derive_kernel (a double-buffered HBM->VMEM->HBM copy pipe whose
// input offset walks the disparity shift, with 128-lane-aligned windows).
//
// What bounds it: bytes, one read and one write of the volume
// (2 x D*H*W*4 bytes) and no arithmetic. A copy: bit-exact.
//
// Where rows are 16-byte aligned (W % 4 == 0, aligned base pointers), one
// warp copies 128 consecutive x of one (i, y) row, four per lane, with one
// 16-byte load and one 16-byte store per lane. The shifted window starts
// r = (d_min + i * stride) mod 4 floats past an aligned address a: lane l
// loads the aligned float4 at a + 4l, takes the r floats it lacks from
// lane l + 1 by shuffle (lane 31 loads the float4 after the window), and
// shifts them in registers, so both sides move whole 512-byte runs. An
// aligned float4 lies wholly inside or wholly outside [0, W), so the
// `fill` columns are whole vectors, and the row's ragged end is the
// x < W test of the store. Other shapes take a scalar copy: one thread per
// element, threads across x.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float4 load4(const float* row, int a, int W,
                                        float fill) {
  return (a >= 0 && a + 4 <= W)
             ? __ldg(reinterpret_cast<const float4*>(row + a))
             : make_float4(fill, fill, fill, fill);
}

__global__ void derive_right_vec_kernel(const float* __restrict__ vol,
                                        float* __restrict__ out, int H,
                                        int W, int d_min, int stride,
                                        float fill, long long nwarps) {
  const long long gw =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (gw >= nwarps) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int chunks = (W + 127) >> 7;
  const long long rowi = gw / chunks;            // i * H + y
  const int c = (int)(gw - rowi * chunks);
  const int i = (int)(rowi / H);
  const int o = d_min + i * stride;
  const int x = (c << 7) + 4 * lane;             // this lane's first x
  const int r = o & 3;                           // o mod 4, for either sign
  const int a = x + o - r;                       // aligned source start
  const float* row = vol + rowi * W;

  const float4 v0 = load4(row, a, W, fill);
  float4 v1;
  v1.x = __shfl_down_sync(0xffffffffu, v0.x, 1);
  v1.y = __shfl_down_sync(0xffffffffu, v0.y, 1);
  v1.z = __shfl_down_sync(0xffffffffu, v0.z, 1);
  v1.w = __shfl_down_sync(0xffffffffu, v0.w, 1);
  if (lane == 31) v1 = load4(row, a + 4, W, fill);
  if (x >= W) return;

  float4 res;
  switch (r) {
    case 0: res = v0; break;
    case 1: res = make_float4(v0.y, v0.z, v0.w, v1.x); break;
    case 2: res = make_float4(v0.z, v0.w, v1.x, v1.y); break;
    default: res = make_float4(v0.w, v1.x, v1.y, v1.z); break;
  }
  *reinterpret_cast<float4*>(out + rowi * W + x) = res;
}

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
  if (D < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const bool aligned = W % 4 == 0 &&
                       reinterpret_cast<size_t>(vol) % 16 == 0 &&
                       reinterpret_cast<size_t>(out) % 16 == 0;
  if (aligned) {
    const long long nwarps = (long long)D * H * ((W + 127) >> 7);
    const int threads = 256;
    const long long blocks = (nwarps * 32 + threads - 1) / threads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    derive_right_vec_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
        vol, out, H, W, d_min, stride, fill, nwarps);
  } else {
    if (D > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
    const int threads = 128;
    const dim3 grid((W + threads - 1) / threads, H, D);
    derive_right_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        vol, out, H, W, d_min, stride, fill);
  }
  return (int)cudaGetLastError();
}
