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
// Recurrence, grouping, scan step and min as K1 (csrc/sgm_tile.cuh). With
// -fmad=false the result is bit-identical to the plain PyTorch version
// (kernels.sgm_hwd_plain).
//
// What bounds it: bytes (2 volumes per launch, 3 with accumulate), but a
// scan step depends on the previous one, so each path is sequential and
// the card holds only H or W paths (~7-9 warps per SM). A step of a path
// is D contiguous floats on both scan axes, so this layout needs no tile
// shared between paths: one warp per path, and each warp streams its own
// path through a private ring of two tiles of T steps in shared memory,
// filled a tile ahead by 16-byte cp.async (4-byte where D % 4 != 0 or a
// base is not 16-byte aligned). A step waits on shared memory, not on
// device memory, and reads it free of bank conflicts (lane l reads float
// l + 32k of the step); a tile costs one cp.async wait and one
// __syncwarp, and the kernel has no block-wide barrier. For accumulate
// the tile of `out` rides the ring beside the cost tile. Results go from
// registers to device memory, D contiguous floats per step.
//
// What holds it back on the H100 (kernel_ab.py --ablate): at
// (896, 896, 80) the scan alone takes ~65 % of a forward launch's time and
// the loads alone ~50 % (at (1152, 1152, 144) ~45 % each), and the two
// overlap for most of their length: a launch reaches 75-81 % of its bound
// on both axes. T comes from the wrapper's launch plan
// (kernels.sgm_hwd_plan): rings of ~10 KB per warp were the fastest at
// D = 80 and 144 (longer tiles ran slower). A block is 2 warps: 1, 2 and 4
// tied and 8 lost. Hopper's bulk copy (one lane starting cp.async.bulk for
// a tile's runs against an mbarrier) tied with cp.async, so the simpler
// copy stays.

#include "sgm_tile.cuh"

namespace {

constexpr int kWarps = 2;      // warps (paths) per block


template <int kPer, bool kAcc>
__global__ void __launch_bounds__(32 * kWarps)
sgm_hwd_kernel(const float* __restrict__ cost, float* out, int D, int S,
               int span, long long sS, long long sL, float p1, float p2,
               int reverse, int T, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int path = blockIdx.x * kWarps + warp;
  if (path >= span) return;  // the whole warp leaves together
  const int Dq = (D + 3) & ~3;                   // a step's floats in the ring
  const int tile = T * Dq;
  const int slot = kAcc ? 2 * tile : tile;       // cost tile (+ out tile)
  float* ring = smem + warp * kStages * slot;    // this warp's own
  const float* cpath = cost + path * sL;
  float* opath = out + path * sL;
  const int ntiles = (S + T - 1) / T;
  const int w = vec ? 4 : 1;
  const int per_step = D / w;                    // copies of one step
  // scan-alone builds keep the stores reachable, or the scan is dead code
  const bool store = kCopy || p1 == -FLT_MAX;


  auto load = [&](int j) {
    if (!kCopy) return;
    int s_lo, nt;
    tile_range(S, T, reverse, j, s_lo, nt);
    float* c = ring + (j % kStages) * slot;
    for (int i = lane; i < nt * per_step; i += 32) {
      const int t = i / per_step, r = (i - t * per_step) * w;
      const long long gi = (long long)(s_lo + t) * sS + r;
      cp_async(c + t * Dq + r, cpath + gi, vec);
      if (kAcc) cp_async(c + tile + t * Dq + r, opath + gi, vec);
    }
  };

  load(0);
  cp_async_commit();

  // this lane's disparities: d = lane + 32 k, valid for k < nvalid
  const int nvalid = (D - lane + 31) >> 5;
  const int dat = reverse ? -Dq : Dq;  // one scan step through the tile
  float prev[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) prev[k] = 0.f;
  float m = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    __syncwarp();  // tile j landed; every lane is done with tile j - 1
    if (j + 1 < ntiles) load(j + 1);
    cp_async_commit();
    if (!kScan) continue;

    int s_lo, nt;
    tile_range(S, T, reverse, j, s_lo, nt);
    const int ls0 = reverse ? nt - 1 : 0;
    const float* at = ring + (j % kStages) * slot + ls0 * Dq + lane;
    float* o = opath + (long long)(s_lo + ls0) * sS + lane;
    const long long ostep = reverse ? -sS : sS;
    float c[kPer], a[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      c[k] = k < nvalid ? at[32 * k] : 0.f;
      a[k] = kAcc && k < nvalid ? at[tile + 32 * k] : 0.f;
    }
    for (int q = 0; q < nt; ++q) {
      // the next step's inputs, read while this step computes
      float cn[kPer], an[kPer];
      if (q + 1 < nt) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          cn[k] = k < nvalid ? at[dat + 32 * k] : 0.f;
          an[k] = kAcc && k < nvalid ? at[dat + tile + 32 * k] : 0.f;
        }
      }
      scan_step<kPer>(prev, c, m, lane, D, nvalid, p1, p2);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (store && k < nvalid) o[32 * k] = kAcc ? a[k] + prev[k] : prev[k];
        c[k] = cn[k];
        a[k] = an[k];
      }
      at += dat;
      o += ostep;
    }
  }
  cp_async_wait_all();
}

using HwdKernel = void (*)(const float*, float*, int, int, int, long long,
                           long long, float, float, int, int, int);

// The kernel for per = per_lane(D) disparities per lane.
template <int kPer>
struct HwdKernels {
  static HwdKernel get(int per, bool acc) {
    if constexpr (kBuilt<kPer>) {
      if (per == kPer)
        return acc ? sgm_hwd_kernel<kPer, true> : sgm_hwd_kernel<kPer, false>;
    }
    return HwdKernels<kPer - 1>::get(per, acc);
  }
};

template <>
struct HwdKernels<0> {
  static HwdKernel get(int, bool) { return nullptr; }
};

}  // namespace

extern "C" int pcmi_sgm_hwd_max_disp() { return 32 * kMaxPer; }

// cost, out: (H, W, D) float32, contiguous, on the current device.
// scan_axis 0 scans H (T->B, or B->T with reverse; paths are columns),
// 1 scans W (L->R, or R->L; paths are rows). accumulate != 0 adds the
// direction into `out` (out = out + L) instead of storing it. The launch
// plan: each warp of a block has a ring of two tiles of `tile` steps (twice
// that with accumulate) in shared memory. Returns a cudaError_t.
extern "C" int pcmi_sgm_hwd(const float* cost, float* out, int H, int W,
                            int D, int scan_axis, int reverse,
                            int accumulate, float p1, float p2, int tile,
                            void* stream) {
  const long long smem = (long long)kWarps * kStages * (accumulate ? 2 : 1) *
                         tile * ((D + 3) & ~3) * (long long)sizeof(float);
  if (per_lane(D) == 0 || H < 1 || W < 1 ||
      (scan_axis != 0 && scan_axis != 1) || tile < 1 || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const HwdKernel fn = HwdKernels<kMaxPer>::get(per_lane(D), accumulate != 0);
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(fn));
  if (e != cudaSuccess) return (int)e;
  const long long rowW = (long long)W * D;
  const int S = scan_axis == 0 ? H : W;
  const int span = scan_axis == 0 ? W : H;
  const long long sS = scan_axis == 0 ? rowW : D;
  const long long sL = scan_axis == 0 ? D : rowW;
  const int vec = D % 4 == 0 && aligned16(cost) && aligned16(out);
  fn<<<(span + kWarps - 1) / kWarps, 32 * kWarps, (size_t)smem,
       (cudaStream_t)stream>>>(cost, out, D, S, span, sS, sL, p1, p2, reverse,
                               tile, vec);
  return (int)cudaGetLastError();
}
