// K5 sgm_blocked: one semi-global aggregation direction over a blocked
// (nb, S, Dp, 128) float32 volume (bands of 128 contiguous lanes), with an
// optional second input added to the output.
//
// Replaces: pcmi_tpu/ops/stereo/pallas_kernels.py, _blocked_dir_sum /
// _make_blocked_kernel (grid (bands, chunks), the state carried in VMEM
// scratch across the sequential chunk axis; with_prev adds the forward
// pass into the backward pass's output, so both directions cost three
// volume passes).
//
// Recurrence and grouping as K1 (csrc/sgm_dir.cu), state zero at the path
// start, "no neighbour" (1e9) outside [0, Dp); with `prev` the output is
// L + prev. Only adds and mins: with -fmad=false the result is
// bit-identical to the plain PyTorch version (kernels.sgm_blocked_plain).
//
// What bounds it: each lane is one path and the min over D stays inside
// its thread, so a step is a serial walk over Dp disparities per thread
// and the card holds only nb * 128 threads (896 at the headline): the
// kernel is bound by that walk, a shared-memory load -> min/add -> store
// chain per disparity that one warp per SM cannot hide (~80 cycles per
// disparity measured on an H100 at 700 W), not by bandwidth. A block is
// one warp holding 32 lanes of a band; its state,
// [Dp][32] floats, lives in shared memory (thread l owns column l, so no
// bank conflicts and no barrier for it). A step's inputs, Dp rows of 128
// contiguous bytes, are staged into shared memory with cp.async one step
// ahead (double-buffered), so the load of step s + 1 overlaps the walk of
// step s. Shared memory: (3 or 5) x Dp x 128 bytes, 184 KB at Dp = 288
// with `prev`, above the 48 KB default: the launch opts in.

#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <cfloat>

namespace {

constexpr int kBand = 128;    // lanes per band (the blocked layout's minor axis)
constexpr int kLanes = 32;    // lanes per block
constexpr int kChunks = kLanes / 4;  // 16-byte copies per staged row
constexpr int kMaxDp = 352;   // (1 + 2 + 2) x 352 x 128 B = 220 KB <= 227 KB
constexpr float kBig = 1e9f;

__global__ void sgm_blocked_kernel(const float* __restrict__ cost,
                                   const float* __restrict__ prev_in,
                                   float* __restrict__ out, int S, int Dp,
                                   float p1, float p2, int reverse) {
  extern __shared__ float4 smem4[];
  float* state = reinterpret_cast<float*>(smem4);   // [Dp][kLanes]
  float* cstage = state + Dp * kLanes;              // [2][Dp][kLanes]
  float* pstage = cstage + 2 * Dp * kLanes;         // [2][Dp][kLanes]

  const int lane = threadIdx.x;
  const int band = blockIdx.x / (kBand / kLanes);
  const int q = blockIdx.x % (kBand / kLanes);
  const long long stepStride = (long long)Dp * kBand;
  const long long bandBase = (long long)band * S * stepStride + q * kLanes;

  for (int d = 0; d < Dp; ++d) state[d * kLanes + lane] = 0.f;

  auto stage_step = [&](int s, int buf) {
    const long long src = bandBase + s * stepStride;
    for (int c = lane; c < Dp * kChunks; c += kLanes) {
      const int d = c / kChunks;
      const int j = (c % kChunks) * 4;
      const int dst = (buf * Dp + d) * kLanes + j;
      __pipeline_memcpy_async(cstage + dst, cost + src + d * kBand + j, 16);
      if (prev_in)
        __pipeline_memcpy_async(pstage + dst, prev_in + src + d * kBand + j,
                                16);
    }
    __pipeline_commit();
  };
  stage_step(reverse ? S - 1 : 0, 0);

  float m = 0.f;
  for (int t = 0; t < S; ++t) {
    const int s = reverse ? S - 1 - t : t;
    const int buf = t & 1;
    if (t + 1 < S) {
      stage_step(reverse ? s - 1 : s + 1, buf ^ 1);
      __pipeline_wait_prior(1);  // this step's copies have landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // ... and are visible to every thread

    const float* c = cstage + buf * Dp * kLanes + lane;
    const float* pv = pstage + buf * Dp * kLanes + lane;
    float* o = out + bandBase + s * stepStride + lane;
    const float mp2 = m + p2;
    float pu = kBig;
    float pp = state[lane];
    float local = FLT_MAX;
    for (int d = 0; d < Dp; ++d) {
      const float pd = d + 1 < Dp ? state[(d + 1) * kLanes + lane] : kBig;
      const float best = fminf(fminf(pp, mp2), fminf(pu + p1, pd + p1));
      const float v = (c[d * kLanes] + best) - m;
      state[d * kLanes + lane] = v;
      local = fminf(local, v);
      o[(long long)d * kBand] = prev_in ? v + pv[d * kLanes] : v;
      pu = pp;
      pp = pd;
    }
    m = local;
    __syncthreads();  // the buffer read here is refilled next step
  }
}

}  // namespace

extern "C" int pcmi_sgm_blocked_max_disp() { return kMaxDp; }

// cost, out (and prev, which may be null): (nb, S, Dp, 128) float32,
// contiguous, 16-byte aligned, on the current device. Scans S forward, or
// backward with reverse; out = L, or L + prev. Returns a cudaError_t.
extern "C" int pcmi_sgm_blocked(const float* cost, const float* prev,
                                float* out, int nb, int S, int Dp, float p1,
                                float p2, int reverse, void* stream) {
  if (nb < 1 || S < 1 || Dp < 1 || Dp > kMaxDp)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(prev ? 5 : 3) * Dp * kLanes * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sgm_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sgm_blocked_kernel<<<nb * (kBand / kLanes), kLanes, smem,
                       (cudaStream_t)stream>>>(cost, prev, out, S, Dp, p1,
                                               p2, reverse);
  return (int)cudaGetLastError();
}
