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
// (2 x Wp*Dp*Hp elements of 4 or 2 bytes; rows that are constant skip
// their read, so the bytes moved are a little fewer). The volume is Wp*Dp
// rows of Hp contiguous elements, and every output row (x, d) is one
// thing: a copy of source row (x + d_min + d*stride, d), or all `fill`, all
// 1e9 or all 0. So one warp takes one row, decides its case once, and
// moves it in 16-byte units, eight per lane issued before any is stored
// (4 KB of a row in flight per warp), with streaming cache hints (nothing
// is read twice); a constant row is only written. The first design ran one
// thread per element and one 128-thread block per 512 bytes, so its time
// followed the element count: bfloat16 took float32's time.
//
// The kernel moves bits and is blind to the element type: `fill`, 1e9 and
// 0 arrive as bit patterns of the stored type (1e9 is 998244352 and 1e4 is
// 9984 in bfloat16, as the TPU kernel casts them), repeated over the unit.
// The unit is the widest of 16, 8, 4 and 2 bytes that divides the row's
// byte length and both pointers; the padded volumes the layouts build (Hp a
// multiple of 128) always take 16, and any other row length or storage
// offset takes a narrower unit. A copy: bit-exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr float kBig = 1e9f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 8;  // units per lane in flight

template <typename T>
__global__ void __launch_bounds__(kThreads)
    derive_rows_kernel(const T* __restrict__ vol, T* __restrict__ out,
                       long long rows, int Dp, long long units, int d_real,
                       int w, int d_min, int stride, T fill, T big) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int x = (int)(row / Dp);
  const int d = (int)(row - (long long)x * Dp);
  T* dst = out + row * units;
  const T* src = nullptr;
  T c{};  // 0 for x >= w
  if (x < w) {
    const long long xs = (long long)x + d_min + (long long)d * stride;
    if (d >= d_real) c = big;
    else if (xs >= 0 && xs < w) src = vol + (xs * Dp + d) * units;
    else c = fill;
  }
  constexpr int kChunk = 32 * kPerLane;
  if (src) {
    for (long long i0 = lane; i0 < units; i0 += kChunk) {
      T r[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        if (i0 + 32 * k < units) r[k] = __ldcs(src + i0 + 32 * k);
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        if (i0 + 32 * k < units) __stcs(dst + i0 + 32 * k, r[k]);
    }
  } else {
    for (long long i = lane; i < units; i += 32) __stcs(dst + i, c);
  }
}

// `bits` (the element's pattern, esize bytes) repeated over a unit T
template <typename T>
T repeated(uint32_t bits, int esize) {
  const uint32_t word = esize == 4 ? bits : (bits & 0xffffu) * 0x10001u;
  uint32_t words[4] = {word, word, word, word};
  T t;
  std::memcpy(&t, words, sizeof(T));
  return t;
}

template <typename T>
void launch(const void* vol, void* out, int Wp, int Dp, int Hp, int esize,
            int d_real, int w, int d_min, int stride, uint32_t fill_bits,
            uint32_t big_bits, cudaStream_t s) {
  const long long rows = (long long)Wp * Dp;
  const long long units = (long long)Hp * esize / (long long)sizeof(T);
  const long long blocks = (rows + kWarps - 1) / kWarps;
  derive_rows_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(vol), static_cast<T*>(out), rows, Dp, units,
      d_real, w, d_min, stride, repeated<T>(fill_bits, esize),
      repeated<T>(big_bits, esize));
}

}  // namespace

// vol, out: (Wp, Dp, Hp) float32, or bfloat16 with bf16 != 0, contiguous;
// d_real <= Dp and w <= Wp are
// the real disparity count and image width. Returns a cudaError_t.
extern "C" int pcmi_derive_right_wdh(const void* vol, void* out, int Wp,
                                     int Dp, int Hp, int d_real, int w,
                                     int d_min, int stride, float fill,
                                     int bf16, void* stream) {
  if (Wp < 1 || Dp < 1 || Hp < 1 || d_real < 1 || d_real > Dp || w < 1 ||
      w > Wp)
    return (int)cudaErrorInvalidValue;
  const int esize = bf16 ? 2 : 4;
  uint32_t fill_bits, big_bits;
  if (bf16) {
    const __nv_bfloat16 f = __float2bfloat16_rn(fill);
    const __nv_bfloat16 g = __float2bfloat16_rn(kBig);
    uint16_t fb, gb;
    std::memcpy(&fb, &f, 2);
    std::memcpy(&gb, &g, 2);
    fill_bits = fb;
    big_bits = gb;
  } else {
    std::memcpy(&fill_bits, &fill, 4);
    std::memcpy(&big_bits, &kBig, 4);
  }
  // the widest unit that divides the row's bytes and both addresses
  const uintptr_t al = reinterpret_cast<uintptr_t>(vol) |
                       reinterpret_cast<uintptr_t>(out) |
                       (uintptr_t)((size_t)Hp * esize);
  if (al % esize) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  if (al % 16 == 0)
    launch<uint4>(vol, out, Wp, Dp, Hp, esize, d_real, w, d_min, stride,
                  fill_bits, big_bits, s);
  else if (al % 8 == 0)
    launch<uint2>(vol, out, Wp, Dp, Hp, esize, d_real, w, d_min, stride,
                  fill_bits, big_bits, s);
  else if (al % 4 == 0)
    launch<unsigned int>(vol, out, Wp, Dp, Hp, esize, d_real, w, d_min,
                         stride, fill_bits, big_bits, s);
  else
    launch<unsigned short>(vol, out, Wp, Dp, Hp, esize, d_real, w, d_min,
                           stride, fill_bits, big_bits, s);
  return (int)cudaGetLastError();
}
