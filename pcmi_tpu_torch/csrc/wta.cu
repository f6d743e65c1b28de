// K2 wta: combine one or two (D, H, W) float32 or bfloat16 aggregates and
// take the winner-takes-all disparity, its cost and its uniqueness margin.
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
//   margin = min_{|d - idx| > 1} s_d - best   (BIG - best if no such d,
//            BIG = 1e9 in the volume's type: 998244352 in bfloat16)
// Costs must lie below 1e9 (the reference's BIG), as every volume the
// matcher builds does.
//
// On bfloat16 volumes the combine is the TPU kernels' bfloat16 arithmetic:
// a_d + b_d is a bfloat16 add and the product with `scale` (itself rounded
// to bfloat16) a bfloat16 multiply, each rounded to nearest-even, as
// `hsum = lr + rl` and `vert + hsum` are. The card's packed bfloat16x2 add
// and multiply round the exact result once; widening to float32, computing
// and rounding gives the same bits (float32 holds more than twice
// bfloat16's 8 significant bits plus two, so the double rounding is
// harmless). s_d is then widened: argmin, parabola, best and margin are
// float32 and go to float32 planes, and agg_out takes s_d as bfloat16.
//
// With agg_out the kernel also stores s_d to agg_out[d, y, x] ((D, H, W),
// where the TPU kernel keeps its padded (W, Dp, H) scan layout): the right
// view of right_sgm="diagonal" is then one diagonal argmin over that
// volume (matching.diag_right_disparity).
//
// What bounds it: one read of each input volume (D*H*W elements of 4 or 2
// bytes per input); the outputs are two or three (H, W) planes, and with
// agg_out one volume more, written in the same walk. One thread walks D
// for one pixel (float32) or two neighbouring pixels (bfloat16, one 32-bit
// load per input and slice; an odd H*W or storage off a 4-byte address
// takes one pixel per thread), so a warp reads 128 consecutive bytes of
// one disparity slice per load. The first design (one load per input and
// step, then a sorted top-4 insertion of ~20 compares and selects per
// pixel, in every form) was bound by loads in float32 and by that walk in
// bfloat16, where the bytes per instruction halve (kernel_ab.py --ablate).
// This one does two things:
//   - instructions per element: the margin needs no top-4. With strict
//     `<` the running best changes only on a new first minimum; at that
//     step the best candidates left of it are the running minimum of
//     s_0..s_{d-2} (kept one step behind), and those right of it are the
//     minimum of what comes after s_{idx+1}. So the walk keeps the best,
//     its index and neighbours, the minimum of those candidates and that
//     lagging minimum: 9 instructions per element in the full form, 3 for
//     the right view's integer argmin (each form is its own
//     instantiation). In bfloat16 the combine is two packed instructions
//     per pair of pixels.
//   - bytes in flight: the d-loop runs in chunks whose loads are all
//     issued before the chunk is walked, 4 slices in float32 and 8 in
//     bfloat16 (per thread 32 bytes in flight with two inputs); longer
//     chunks, or a second buffer that loads the next chunk while this one
//     is walked, hold more registers, fewer threads per SM and measured
//     no faster.
// The result is the same value, bit for bit, as the plain version's.
//
// Ablation switches (kernel_ab.py --ablate; never in the library the
// package builds): -DWTA_NO_CHAIN replaces the walk by a float sum of the
// combined values (loads, combine and stores alone); -DWTA_NO_LOADS makes
// the raw values from the pixel and slice index instead of loading them
// and stores no aggregate (the combine and the walk alone).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;
constexpr int kThreads = 256;
using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

// BIG in bfloat16: the margin's value where no slice is far enough
inline float big16() { return __bfloat162float(__float2bfloat16_rn(kBig)); }

// One element layout: the raw unit a thread loads per input and slice,
// how it combines, how it widens into kPix float32 values, the slices per
// chunk of the walk, and BIG in its type.
struct F32 {  // float32, one pixel per thread
  using Raw = float;
  using Scale = float;
  static constexpr int kPix = 1;
  static constexpr int kUnroll = 4;
  static float big() { return kBig; }
  template <bool kTwo>
  __device__ static Raw combine(Raw a, Raw b, Scale sc) {
    return (kTwo ? a + b : a) * sc;
  }
  __device__ static void widen(Raw s, float (&v)[kPix]) { v[0] = s; }
};
struct B16x2 {  // bfloat16, two neighbouring pixels per thread
  using Raw = bf162;
  using Scale = bf162;
  static constexpr int kPix = 2;
  static constexpr int kUnroll = 8;
  static float big() { return big16(); }
  template <bool kTwo>
  __device__ static Raw combine(Raw a, Raw b, Scale sc) {
    return __hmul2(kTwo ? __hadd2(a, b) : a, sc);
  }
  __device__ static void widen(Raw s, float (&v)[kPix]) {
    v[0] = __low2float(s);
    v[1] = __high2float(s);
  }
};
struct B16 {  // bfloat16, one pixel per thread
  using Raw = bf16;
  using Scale = bf16;
  static constexpr int kPix = 1;
  static constexpr int kUnroll = 8;
  static float big() { return big16(); }
  template <bool kTwo>
  __device__ static Raw combine(Raw a, Raw b, Scale sc) {
    return __hmul(kTwo ? __hadd(a, b) : a, sc);
  }
  __device__ static void widen(Raw s, float (&v)[kPix]) {
    v[0] = __bfloat162float(s);
  }
};

#ifdef WTA_NO_LOADS
// raw values in [0.5, 1) made from a hash, in place of a load
__device__ __forceinline__ void made(unsigned h, float& r) {
  r = __uint_as_float(0x3f000000u | (h >> 9));
}
__device__ __forceinline__ void made(unsigned h, bf162& r) {
  const unsigned u = 0x3f003f00u | ((h >> 9) & 0x007f007fu);
  r = *reinterpret_cast<const bf162*>(&u);
}
__device__ __forceinline__ void made(unsigned h, bf16& r) {
  r = __ushort_as_bfloat16((unsigned short)(0x3f00u | (h >> 25)));
}
#endif

// The running state of one pixel's walk over d.
struct Walk {
  float v1;     // best so far (first minimum)
  int i1;       // its index
  float prev;   // s_{i1-1} (BIG at i1 = 0)
  float next;   // s_{i1+1} once walked (unread when i1 = D - 1)
  float far;    // min of s_0..s_{i1-2} and s_{i1+2}..s_d (the margin's)
  float lag;    // min s_0..s_{d-2}
  float last;   // s_{d-1}
  float last2;  // s_{d-2}
  bool fresh;   // the step before found a new best
};

__device__ __forceinline__ void init(Walk& w, float big) {
  w.v1 = __int_as_float(0x7f800000);  // +inf: slice 0 always takes it
  w.i1 = 0;
  w.prev = w.next = w.far = w.lag = w.last = w.last2 = big;
  w.fresh = false;
}

template <bool kSub, bool kMargin>
__device__ __forceinline__ void step(Walk& w, float val, int d) {
#ifdef WTA_NO_CHAIN
  w.v1 += val;
  return;
#endif
  const bool nb = val < w.v1;
  if (kMargin) {
    // a new best at d: everything left of d - 1 is a candidate, nothing
    // right of it yet; else every slice but the best's right neighbour
    w.lag = fminf(w.lag, w.last2);
    w.far = nb ? w.lag : (w.fresh ? w.far : fminf(w.far, val));
  }
  if (kSub) {
    w.prev = nb ? w.last : w.prev;
    w.next = w.fresh ? val : w.next;
  }
  w.fresh = nb;
  w.v1 = nb ? val : w.v1;
  w.i1 = nb ? d : w.i1;
  w.last2 = w.last;
  w.last = val;
}

// Issue the loads of slices d0 .. d0 + count - 1 (count <= U; a literal U
// for whole chunks, so the guards fold away). Nothing is read twice, so the
// loads are marked evict-first, but for the form that also stores the
// aggregate: beside that store stream such loads ran slower than plain
// ones on the H100.
template <typename L, bool kTwo, bool kAgg, int U>
__device__ __forceinline__ void fetch(const typename L::Raw* a,
                                      const typename L::Raw* b, long long n,
                                      int d0, int count, long long t,
                                      typename L::Raw (&ra)[U],
                                      typename L::Raw (&rb)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < count) {
      const long long o = (long long)(d0 + u) * n;
#ifdef WTA_NO_LOADS
      const unsigned h = (unsigned)t * 0x9E3779B1u + (d0 + u) * 0x85EBCA77u;
      made(h, ra[u]);
      if (kTwo) made(h * 0xC2B2AE35u, rb[u]);
      (void)o;
#else
      ra[u] = kAgg ? a[o] : __ldcs(a + o);
      if (kTwo) rb[u] = kAgg ? b[o] : __ldcs(b + o);
      (void)t;
#endif
    }
  }
}

// Combine, store and walk the fetched slices d0 .. d0 + count - 1.
template <typename L, bool kTwo, bool kAgg, bool kSub, bool kMargin, int U>
__device__ __forceinline__ void walk(Walk (&w)[L::kPix],
                                     const typename L::Raw (&ra)[U],
                                     const typename L::Raw (&rb)[U], int d0,
                                     int count, long long n,
                                     typename L::Scale sc,
                                     typename L::Raw* agg) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < count) {
      const typename L::Raw s = L::template combine<kTwo>(ra[u], rb[u], sc);
#ifndef WTA_NO_LOADS
      if (kAgg) agg[(long long)(d0 + u) * n] = s;
#endif
      float v[L::kPix];
      L::widen(s, v);
#pragma unroll
      for (int q = 0; q < L::kPix; ++q)
        step<kSub, kMargin>(w[q], v[q], d0 + u);
    }
  }
}

template <typename L, bool kTwo, bool kAgg, bool kSub, bool kMargin>
__global__ void __launch_bounds__(kThreads)
    wta_kernel(const typename L::Raw* __restrict__ a,
               const typename L::Raw* __restrict__ b, int D, long long n,
               typename L::Scale sc, float big, float d_min, float stride,
               float* __restrict__ disp, float* __restrict__ best_out,
               float* __restrict__ margin_out,
               typename L::Raw* __restrict__ agg) {
  using Raw = typename L::Raw;
  constexpr int U = L::kUnroll;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  a += t;
  if (kTwo) b += t;
  if (kAgg) agg += t;
  Walk w[L::kPix];
#pragma unroll
  for (int q = 0; q < L::kPix; ++q) init(w[q], big);

  // chunks of U slices: all U loads of a chunk are issued before it is
  // walked; the last chunk may be shorter
  Raw ra[U], rb[U];
  for (int d0 = 0; d0 < D; d0 += U) {
    if (d0 + U <= D) {
      fetch<L, kTwo, kAgg, U>(a, b, n, d0, U, t, ra, rb);
      walk<L, kTwo, kAgg, kSub, kMargin, U>(w, ra, rb, d0, U, n, sc, agg);
    } else {
      fetch<L, kTwo, kAgg, U>(a, b, n, d0, D - d0, t, ra, rb);
      walk<L, kTwo, kAgg, kSub, kMargin, U>(w, ra, rb, d0, D - d0, n, sc,
                                            agg);
    }
  }

#pragma unroll
  for (int q = 0; q < L::kPix; ++q) {
    const long long p = t * L::kPix + q;
    float off = 0.f;
    if (kSub) {
      const float denom = (w[q].prev - 2.f * w[q].v1) + w[q].next;
      if (denom > 1e-9f && w[q].i1 > 0 && w[q].i1 < D - 1)
        off = 0.5f * (w[q].prev - w[q].next) / fmaxf(denom, 1e-9f);
      off = fminf(fmaxf(off, -1.f), 1.f);
    }
    disp[p] = d_min + stride * ((float)w[q].i1 + off);
    best_out[p] = w[q].v1;
    if (kMargin) margin_out[p] = w[q].far - w[q].v1;
  }
}

struct Args {
  const void* a;
  const void* b;
  int D;
  long long n;  // raw units per slice
  float scale;
  float d_min, stride;
  float* disp;
  float* best;
  float* margin;
  void* agg;
};

template <typename L>
typename L::Scale scale_of(float s);
template <>
float scale_of<F32>(float s) { return s; }
template <>
bf162 scale_of<B16x2>(float s) { return __float2bfloat162_rn(s); }
template <>
bf16 scale_of<B16>(float s) { return __float2bfloat16_rn(s); }

template <typename L, bool kTwo, bool kAgg, bool kSub, bool kMargin>
void launch(const Args& g, cudaStream_t stream) {
  using Raw = typename L::Raw;
  const unsigned blocks = (unsigned)((g.n + kThreads - 1) / kThreads);
  wta_kernel<L, kTwo, kAgg, kSub, kMargin><<<blocks, kThreads, 0, stream>>>(
      static_cast<const Raw*>(g.a), static_cast<const Raw*>(g.b), g.D, g.n,
      scale_of<L>(g.scale), L::big(), g.d_min, g.stride, g.disp, g.best,
      g.margin, static_cast<Raw*>(g.agg));
}

template <typename L, bool kTwo, bool kAgg>
void launch_form(const Args& g, bool sub, cudaStream_t s) {
  const bool mg = g.margin != nullptr;
  if (sub && mg) launch<L, kTwo, kAgg, true, true>(g, s);
  else if (sub) launch<L, kTwo, kAgg, true, false>(g, s);
  else if (mg) launch<L, kTwo, kAgg, false, true>(g, s);
  else launch<L, kTwo, kAgg, false, false>(g, s);
}

// the aggregate output combines two inputs
template <typename L>
void launch_inputs(const Args& g, bool sub, cudaStream_t s) {
  if (g.agg) launch_form<L, true, true>(g, sub, s);
  else if (g.b) launch_form<L, true, false>(g, sub, s);
  else launch_form<L, false, false>(g, sub, s);
}

inline bool aligned4(const void* p) {
  return reinterpret_cast<size_t>(p) % 4 == 0;
}

}  // namespace

// a, b: (D, H, W) float32, or bfloat16 with bf16_in != 0, contiguous (b may
// be null); disp, best: (H, W) float32; margin: (H, W) float32 or null; agg:
// (D, H, W) of the inputs' type or null (with b only). Returns a
// cudaError_t.
extern "C" int pcmi_wta(const void* a, const void* b, int D, int H, int W,
                        float scale, float d_min, float stride, int subpixel,
                        float* disp, float* best, float* margin, void* agg,
                        int bf16_in, void* stream) {
  if (D < 1 || H < 1 || W < 1 || (agg && !b))
    return (int)cudaErrorInvalidValue;
  const long long HW = (long long)H * W;
  const cudaStream_t s = (cudaStream_t)stream;
  Args g{a, b, D, HW, scale, d_min, stride, disp, best, margin, agg};
  if (!bf16_in) {
    launch_inputs<F32>(g, subpixel != 0, s);
  } else if (HW % 2 == 0 && aligned4(a) && aligned4(b) && aligned4(agg)) {
    g.n = HW / 2;
    launch_inputs<B16x2>(g, subpixel != 0, s);
  } else {
    launch_inputs<B16>(g, subpixel != 0, s);
  }
  return (int)cudaGetLastError();
}
