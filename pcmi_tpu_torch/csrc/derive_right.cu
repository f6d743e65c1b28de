// K3 derive_right: the right-view cost volume from the left one,
//   out[i, y, x] = vol[i, y, x + d_min + i * stride]   (fill out of range)
//
// Replaces: pcmi_tpu/ops/stereo/pallas_kernels.py, derive_right_pallas /
// _make_derive_kernel (a double-buffered HBM->VMEM->HBM copy pipe whose
// input offset walks the disparity shift, with 128-lane-aligned windows).
//
// What bounds it: bytes, one read and one write of the volume
// (2 x D*H*W elements of 4 or 2 bytes) and no arithmetic. A copy:
// bit-exact, blind to the element type but for `fill`, which arrives in
// the stored type (1e4 is 9984 in bfloat16, as the TPU kernel casts it).
//
// Where rows are 16-byte aligned (W a multiple of the 4 float32 or 8
// bfloat16 of a 16-byte vector, aligned base pointers), one warp copies 32
// consecutive vectors of one (i, y) row, one per lane, with one 16-byte
// load and one 16-byte store per lane. The kernel moves 32-bit words. The
// shifted window starts r elements past an aligned address a (r = (d_min
// + i * stride) mod 4 or 8): lane l loads the aligned vector at a + l
// vectors, takes the words it lacks from lane l + 1 by shuffle (lane 31
// loads the vector after the window) and shifts them in registers, so both
// sides move whole 512-byte runs. In float32 a shift is whole words; in
// bfloat16 an odd r splits words, and each output word is then the funnel
// shift of two neighbouring words. An aligned vector lies wholly inside or
// wholly outside [0, W), so the `fill` columns are whole vectors, and the
// row's ragged end is the x < W test of the store. Other shapes take a
// scalar copy: one thread per element, threads across x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstring>

namespace {

// kPer elements to a vector: 4 (float32) or 8 (bfloat16). `fill` is one
// 32-bit word of fill elements.
template <int kPer>
__device__ __forceinline__ uint4 load_vec(const unsigned* row, int a, int W,
                                          unsigned fill) {
  return (a >= 0 && a + kPer <= W)
             ? __ldg(reinterpret_cast<const uint4*>(row + a / (kPer / 4)))
             : make_uint4(fill, fill, fill, fill);
}

template <int kPer>
__global__ void derive_right_vec_kernel(const unsigned* __restrict__ vol,
                                        unsigned* __restrict__ out, int H,
                                        int W, int d_min, int stride,
                                        unsigned fill, long long nwarps) {
  constexpr int kEw = kPer / 4;                   // elements to a word
  const long long gw =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (gw >= nwarps) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int chunks = (W + 32 * kPer - 1) / (32 * kPer);
  const long long rowi = gw / chunks;            // i * H + y
  const int c = (int)(gw - rowi * chunks);
  const int i = (int)(rowi / H);
  const int o = d_min + i * stride;
  const int x = (c * 32 + lane) * kPer;          // this lane's first x
  const int r = o & (kPer - 1);                  // o mod kPer, either sign
  const int a = x + o - r;                       // aligned source start
  const unsigned* row = vol + rowi * (W / kEw);

  const uint4 v0 = load_vec<kPer>(row, a, W, fill);
  uint4 v1;
  v1.x = __shfl_down_sync(0xffffffffu, v0.x, 1);
  v1.y = __shfl_down_sync(0xffffffffu, v0.y, 1);
  v1.z = __shfl_down_sync(0xffffffffu, v0.z, 1);
  v1.w = __shfl_down_sync(0xffffffffu, v0.w, 1);
  if (lane == 31) v1 = load_vec<kPer>(row, a + kPer, W, fill);
  if (x >= W) return;

  // the five words from the window's first: t[0..3], and `t4` for a
  // shift that splits words
  uint4 t;
  unsigned t4;
  switch (r / kEw) {
    case 0: t = v0; t4 = v1.x; break;
    case 1: t = make_uint4(v0.y, v0.z, v0.w, v1.x); t4 = v1.y; break;
    case 2: t = make_uint4(v0.z, v0.w, v1.x, v1.y); t4 = v1.z; break;
    default: t = make_uint4(v0.w, v1.x, v1.y, v1.z); t4 = v1.w; break;
  }
  if (kEw == 2 && (r & 1))
    t = make_uint4(__funnelshift_r(t.x, t.y, 16), __funnelshift_r(t.y, t.z, 16),
                   __funnelshift_r(t.z, t.w, 16), __funnelshift_r(t.w, t4, 16));
  *reinterpret_cast<uint4*>(out + (rowi * W + x) / kEw) = t;
}

template <typename E>
__global__ void derive_right_kernel(const E* __restrict__ vol,
                                    E* __restrict__ out, int H, int W,
                                    int d_min, int stride, E fill) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int i = blockIdx.z;
  if (x >= W) return;
  const long long row = ((long long)i * H + y) * W;
  const int xs = x + d_min + i * stride;
  out[row + x] = (xs >= 0 && xs < W) ? vol[row + xs] : fill;
}

template <typename E>
cudaError_t launch(const E* vol, E* out, int D, int H, int W, int d_min,
                   int stride, E fill, unsigned fill_word,
                   cudaStream_t stream) {
  constexpr int kPer = 16 / (int)sizeof(E);
  const bool aligned = W % kPer == 0 &&
                       reinterpret_cast<size_t>(vol) % 16 == 0 &&
                       reinterpret_cast<size_t>(out) % 16 == 0;
  if (aligned) {
    const long long nwarps =
        (long long)D * H * ((W + 32 * kPer - 1) / (32 * kPer));
    const int threads = 256;
    const long long blocks = (nwarps * 32 + threads - 1) / threads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    derive_right_vec_kernel<kPer><<<(unsigned)blocks, threads, 0, stream>>>(
        reinterpret_cast<const unsigned*>(vol),
        reinterpret_cast<unsigned*>(out), H, W, d_min, stride, fill_word,
        nwarps);
  } else {
    if (D > 65535 || H > 65535) return cudaErrorInvalidValue;
    const int threads = 128;
    const dim3 grid((W + threads - 1) / threads, H, D);
    derive_right_kernel<<<grid, threads, 0, stream>>>(vol, out, H, W, d_min,
                                                      stride, fill);
  }
  return cudaGetLastError();
}

}  // namespace

// vol, out: (D, H, W) float32, or bfloat16 with bf16 != 0, contiguous.
// Returns a cudaError_t.
extern "C" int pcmi_derive_right(const void* vol, void* out, int D, int H,
                                 int W, int d_min, int stride, float fill,
                                 int bf16, void* stream) {
  if (D < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (bf16) {
    const __nv_bfloat16 f = __float2bfloat16_rn(fill);
    const unsigned short bits = *reinterpret_cast<const unsigned short*>(&f);
    return (int)launch(static_cast<const __nv_bfloat16*>(vol),
                       static_cast<__nv_bfloat16*>(out), D, H, W, d_min,
                       stride, f, (unsigned)bits << 16 | bits,
                       (cudaStream_t)stream);
  }
  unsigned word;
  static_assert(sizeof(word) == sizeof(fill), "float32 is one word");
  memcpy(&word, &fill, sizeof(word));
  return (int)launch(static_cast<const float*>(vol), static_cast<float*>(out),
                     D, H, W, d_min, stride, fill, word,
                     (cudaStream_t)stream);
}
