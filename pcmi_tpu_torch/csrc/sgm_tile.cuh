// The SGM scan machinery shared by K1 sgm_dir (csrc/sgm_dir.cu), K5
// sgm_blocked (csrc/sgm_blocked.cu) and K4 sgm_hwd (csrc/sgm_hwd.cu).
//
// Recurrence (Hirschmueller 2008), state zero at the path start, float32
// whatever the volume stores:
//   L(p, d) = C(p, d) + min(L'(d), L'(d-1) + P1, L'(d+1) + P1, min L' + P2)
//             - min L'
// with "no neighbour" (1e9, as the reference's BIG padding) outside [0, D).
// Only adds and mins, grouped as the reference groups them: with
// -fmad=false the kernels are bit-identical to their plain PyTorch
// versions.
//
// All three kernels give one warp to a path: lane l holds the disparities
// d = l + 32k (k < kPer, a template parameter) in registers, the d +- 1
// neighbours are 2 * kPer rotating shuffles per step and the min over D is
// one redux.sync on the floats' order-preserving integer images
// (scan_step). A scan step has no block-wide barrier. kPer is
// ceil(D / 32) up to 16 (D <= 512); above that one kernel of kMaxPer = 32
// per lane takes every D up to 1024, the lane's slots past D idle
// (per_lane), so the build grows by one kernel per kind and not sixteen.
//
// K1 and K5 share one kernel, sgm_tile_kernel (described here for float32
// volumes; "Element types" below says what bfloat16 changes). A block holds P
// neighbouring paths and streams the volume through shared memory in tiles
// of T scan steps, described in element strides (Scan), so the (D, H, W)
// volume on either axis and the blocked (nb, S, Dp, 128) volume are three
// sets of strides:
//
// * a ring of two tiles, filled by 16-byte cp.async.cg, so the next tile
//   is in flight while the scan runs on the current one (deeper rings
//   measured no faster on the H100). Each copy asks L2 for its whole
//   128-byte line. With a second input (K1's accumulate, K5's prev) its
//   tile rides the ring beside the cost tile and the sum is stored.
// * A tile keeps device memory's order: for each disparity a plane of O
//   runs of R consecutive floats (horizontal: P rows of T steps; else T
//   steps of P paths), so every copy and every store is a float4 of one
//   run, and a warp's copies cover whole 32-byte sectors. Planes lie
//   Sp floats apart (Sp = O*R + 4: Sp / 4 odd).
// * The scan reads a step's costs and writes its results in place, in the
//   tile. A horizontal path's tile is scanned 4 steps at a time, one
//   float4 per lane and disparity, free of bank conflicts (Sp / 4 odd);
//   another one a step at a time, one float each, whose 32 lanes fall in
//   8 banks (4 ways), the price of the 16-byte copies. A tile has two
//   block-wide barriers.
// * Runs that are not 16-byte aligned take 4-byte copies and stores into
//   the same layout, and are scanned a step at a time.
//
// The deep horizontal form (sgm_tile_kernel_deep). Deep enough, a block of
// 4 rows fits only tiles of 16 bytes or less a row (float32: 4 steps from
// 808 planes, accumulating from 404, 2 from 727; bfloat16: 8 steps from
// 808, accumulating from 404), so each copy reads 8-16 bytes of a row and
// L2 loses the rest of its line before the next tile asks for it. There a
// block takes 1 or 2 rows and tiles of 16 steps or more (runs of 64 bytes
// and more), and its warps take roles: the scanning warps (one a row)
// only scan; the others store tile j - 1 and load tile j + 1 while tile j
// is scanned, one barrier a tile. The second input leaves the ring: it is
// read from device memory in the store's own 16-byte items, a tile ahead
// into the copying threads' registers, so the accumulating launch fits
// the forward launch's tile. Same recurrence, same adds, same results.
//
// The helpers live in an unnamed namespace (each source that includes this
// file gets its own), but the tile kernel is compiled once: only the source
// that defines SGM_TILE_KERNEL before the include (csrc/sgm_dir.cu) gets
// the kernel and the definition of launch_tiles; the others call it.
//
// Element types. The tile kernel is instantiated for float32 and for
// bfloat16 volumes (Scan.bf16). A bfloat16 tile rides the ring as stored,
// in half the bytes; the scan widens each cost it reads, keeps its state
// in float32 registers and rounds (nearest-even) what it writes back into
// the tile, so the stores move finished bfloat16. A 16-byte copy is then 8
// elements, a 4-byte one 2, and a volume whose rows are not even 4-byte
// aligned (odd W) takes plain 2-byte loads and stores, below cp.async's
// smallest copy. Planes lie 16 bytes more than O*R elements apart, so
// every plane starts 16-byte aligned (in bfloat16 the 8-byte accesses of
// the 4-steps-at-a-time scan then meet 2-way bank conflicts). The second
// input is added by one of the TPU kernels' two rules:
// * at the store (K1's accumulate; float32 always): the direction as
//   stored plus the stored second input, the sum rounded: a bfloat16 add
//   of two stored volumes, as the reference's `lr + rl`;
// * in the scan (bfloat16 with Scan.once, K5's `prev`): the float32 state
//   plus the second input, rounded once, as `_make_blocked_kernel` stores
//   `(st + prev)`.
// In float32 the two rules are one.
//
// Measurement switches (kernel_ab.py --ablate): -DSGM_NO_SCAN builds the
// kernels with the scan left out (the copies and stores alone),
// -DSGM_NO_COPY with the device-memory traffic left out (the scan alone, on
// whatever the ring holds). Neither is set in the library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <type_traits>

namespace {

constexpr int kMaxPer = 32;    // disparities per lane: D <= 1024
constexpr float kBig = 1e9f;   // the reference's no-neighbour value
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 232448;  // dynamic shared memory of one block
constexpr int kStages = 2;      // tiles in a ring
#ifdef SGM_NO_SCAN
constexpr bool kScan = false;
#else
constexpr bool kScan = true;
#endif
#ifdef SGM_NO_COPY
constexpr bool kCopy = false;
#else
constexpr bool kCopy = true;
#endif

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool vec) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec)
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until this thread's copies have all landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// An element widened to float32, and a float32 rounded (nearest-even) into
// an element.
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ float lo_of(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_of(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}
// bfloat16 add of two packed pairs: widened, added, rounded
__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  return pack2(lo_of(a) + lo_of(b), hi_of(a) + hi_of(b));
}

// Four consecutive elements as they lie in a tile (16 or 8 bytes), widened
// to four float32 and rounded back
template <typename E> struct Quad { using type = float4; };
template <> struct Quad<bf16> { using type = uint2; };
__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float4 widen(uint2 u) {
  return make_float4(lo_of(u.x), hi_of(u.x), lo_of(u.y), hi_of(u.y));
}
__device__ __forceinline__ void narrow(float4& q, float4 v) { q = v; }
__device__ __forceinline__ void narrow(uint2& q, float4 v) {
  q = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
}

// Floats as ints that order like the floats (NaN aside), so the warp's min
// is one redux.sync; the map is its own inverse.
__device__ __forceinline__ int ordered(int k) {
  return k ^ ((k >> 31) & 0x7fffffff);
}

// One scan step of one path: prev[k] (disparity lane + 32 k) becomes
// L(p, d) from the step's costs c[k], and m becomes min_d L(p, d). A
// lane's d - 1 is lane l - 1's (lane 0: lane 31's, one k down); its d + 1
// is lane l + 1's (lane 31: lane 0's, one k up). Lanes past D hold
// values no valid disparity reads.
template <int kPer>
__device__ __forceinline__ void scan_step(float (&prev)[kPer],
                                          const float (&c)[kPer], float& m,
                                          int lane, int D, int nvalid,
                                          float p1, float p2) {
  const int left = (lane + 31) & 31, right = (lane + 1) & 31;
  float from_left[kPer], from_right[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    from_left[k] = __shfl_sync(kFull, prev[k], left);
    from_right[k] = __shfl_sync(kFull, prev[k], right);
  }
  const float mp2 = m + p2;
  float local = FLT_MAX;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const float up = lane ? from_left[k] : (k ? from_left[k - 1] : kBig);
    float dn =
        lane < 31 ? from_right[k] : (k + 1 < kPer ? from_right[k + 1] : kBig);
    if (lane + 32 * k + 1 >= D) dn = kBig;
    const float best = fminf(fminf(prev[k], mp2), fminf(up + p1, dn + p1));
    prev[k] = (c[k] + best) - m;
    if (k < nvalid) local = fminf(local, prev[k]);
  }
  m = __int_as_float(
      ordered(__reduce_min_sync(kFull, ordered(__float_as_int(local)))));
}

// The kernel's disparities per lane for D disparities: ceil(D / 32) up to
// 16, kMaxPer above that; 0 past kMaxPer.
inline int per_lane(int D) {
  const int n = (D + 31) / 32;
  return D < 1 || n > kMaxPer ? 0 : n <= 16 ? n : kMaxPer;
}

// Whether kernels are built for kPer disparities per lane (per_lane's
// values).
template <int kPer>
constexpr bool kBuilt = kPer <= 16 || kPer == kMaxPer;

// Kernels above 48 KB of dynamic shared memory must opt in, once each.
inline cudaError_t allow_smem(const void* fn) {
  static const void* seen[8 * kMaxPer];
  static int n = 0;
  for (int i = 0; i < n; ++i)
    if (seen[i] == fn) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e == cudaSuccess && n < 8 * kMaxPer) seen[n++] = fn;
  return e;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

inline bool aligned4(const void* p) {
  return reinterpret_cast<size_t>(p) % 4 == 0;
}

// The tile of scan-order steps [j*T, j*T + nt) covers the volume's steps
// [s_lo, s_lo + nt) in either direction.
__device__ __forceinline__ void tile_range(int S, int T, int reverse, int j,
                                           int& s_lo, int& nt) {
  const int t0 = j * T;
  nt = min(T, S - t0);
  s_lo = reverse ? S - t0 - nt : t0;
}

}  // namespace

// ---------------------------------------------------------------------------
// The tile kernel of K1 and K5
// ---------------------------------------------------------------------------

// The caller sets the volume's fields; launch_tiles derives R, O and Sp.
struct Scan {
  int D, S, span;         // disparities, scan steps, paths (of one band)
  long long sD, sS, sL;   // element strides: disparity, scan step, path
  long long sB;           // element stride between bands (blockIdx.y)
  int horizontal, reverse;
  int T, P;               // a tile's steps; a block's paths
  int R, O, Sp;           // a plane's runs of R elements, O runs, Sp apart
  int vec;                // copies and stores: 1: 16 bytes (4 float32 or 8
                          // bfloat16); 0: one element (float32: 4 bytes;
                          // bfloat16: 2 bytes, no cp.async); 2: 4 bytes
                          // of bfloat16 (2 elements)
  int bf16;               // the volumes are bfloat16, else float32
  int once;               // bfloat16 second input: add in the scan (above)
};

// Scan.vec for runs of `run` elements in rows of W elements of `esize`
// bytes, `a` and `b` the volumes' base pointers.
static inline int copy_mode(int esize, int W, int run, const void* a,
                            const void* b) {
  const int per16 = 16 / esize;
  if (W % per16 == 0 && run % per16 == 0 && aligned16(a) && aligned16(b))
    return 1;
  if (esize == 2 && W % 2 == 0 && run % 2 == 0 && aligned4(a) && aligned4(b))
    return 2;
  return 0;
}

// Launch the tile kernel over `bands` bands of g.span paths each: blocks of
// g.P paths (a power of 2 from 4 to 16) and 8 warps or one warp per path,
// whichever is more, or, horizontal only, the deep form's blocks of 1 or 2
// paths and 8 warps; tiles of g.T steps (a power of 2 up to 32) that fit
// the shared memory. acc_in may be null (no second input) or `out`. The
// pointers are float32 or, with g.bf16, bfloat16 volumes.
// Returns a cudaError_t.
int launch_tiles(const void* cost, const void* acc_in, void* out, Scan g,
                 int bands, float p1, float p2, void* stream);

#ifdef SGM_TILE_KERNEL

namespace {

constexpr int kTileThreads = 512;  // most threads of a block: 16 paths

inline bool pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

// One thread's share of a tile's copies and stores: the element (or the
// vector of w elements) at offset `off` of each plane d0, d0 + dstep, ...;
// `off` lies on path `p` (0 .. P-1) at step `ls` of the tile.
// Thread `tid` of the `threads` that copy (all of the block's, or the deep
// form's copying warps).
template <typename E>
struct Part {
  int off, p, ls, d0, dstep;
  __device__ __forceinline__ explicit Part(const Scan& g)
      : Part(g, threadIdx.x, blockDim.x) {}
  __device__ __forceinline__ Part(const Scan& g, int tid, int threads) {
    const int w = sizeof(E) == 4 ? (g.vec ? 4 : 1)
                                 : (g.vec == 1 ? 8 : g.vec == 2 ? 2 : 1);
    const int n = g.O * g.R / w;       // items of one plane (divides threads)
    off = (tid % n) * w;
    const int o = off / g.R, r = off % g.R;
    p = g.horizontal ? o : r;
    ls = g.horizontal ? r : o;
    d0 = tid / n;
    dstep = threads / n;
  }
};

// f(device index, shared index) for each of this thread's items of the
// tile [s_lo, s_lo + nt) of the paths from `lo`. An item lies wholly inside
// or wholly outside the volume (a run of w elements starts at a multiple of w).
template <typename E, typename F>
__device__ __forceinline__ void for_tile(const Scan& g, const Part<E>& t,
                                         int lo, int s_lo, int nt, F&& f) {
  const int path = lo + t.p;
  if (t.ls >= nt || path >= g.span) return;
  long long gi = t.d0 * g.sD + (long long)path * g.sL +
                 (long long)(s_lo + t.ls) * g.sS;
  const long long gstep = t.dstep * g.sD;
  int si = t.d0 * g.Sp + t.off;
  const int sstep = t.dstep * g.Sp;
#pragma unroll 4
  for (int d = t.d0; d < g.D; d += t.dstep, gi += gstep, si += sstep)
    f(gi, si);
}

__device__ __forceinline__ float& comp(float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 reversed(float4 v) {
  return make_float4(v.w, v.z, v.y, v.x);
}

// The scan of the tile at `buf` (nt steps) along path `warp` of the block:
// its results replace its costs; with kAcc 2 the second input's tile lies
// `tile` elements past it and is added in the scan.
template <typename E, int kPer, int kAcc>
__device__ __forceinline__ void scan_tile(const Scan& g, E* buf, int tile,
                                          int nt, int lane, int warp,
                                          int nvalid, float (&prev)[kPer],
                                          float& m, float p1, float p2) {
  constexpr bool kF32 = std::is_same<E, float>::value;
  const int kstride = 32 * g.Sp;
  // horizontal tiles of whole 16-byte runs are scanned 4 steps at a time:
  // one read and write of 4 elements per disparity (in float32 16 bytes,
  // free of bank conflicts)
  const bool by4 = g.horizontal && (kF32 ? g.vec : g.vec == 1);
  // one scan step moves this many elements through the tile
  const int dat = (g.horizontal ? 1 : g.R) * (g.reverse ? -1 : 1);
  if (by4) {
    E* row = buf + lane * g.Sp + warp * g.R;
    for (int q = 0; q < nt; q += 4) {
      using Q = typename Quad<E>::type;
      Q* at = reinterpret_cast<Q*>(row + (g.reverse ? nt - 4 - q : q));
      float4 cc[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        cc[k] = k < nvalid ? widen(at[k * (kstride / 4)])
                           : make_float4(0, 0, 0, 0);
        if (g.reverse) cc[k] = reversed(cc[k]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float c[kPer];
#pragma unroll
        for (int k = 0; k < kPer; ++k) c[k] = comp(cc[k], e);
        scan_step<kPer>(prev, c, m, lane, g.D, nvalid, p1, p2);
#pragma unroll
        for (int k = 0; k < kPer; ++k) comp(cc[k], e) = prev[k];
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (k < nvalid)
          narrow(at[k * (kstride / 4)], g.reverse ? reversed(cc[k]) : cc[k]);
    }
  } else {
    const int ls0 = g.reverse ? nt - 1 : 0;
    E* at = buf + lane * g.Sp +
            (g.horizontal ? warp * g.R + ls0 : ls0 * g.R + warp);
    float c[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      c[k] = k < nvalid ? ld(at + k * kstride) : 0.f;
    for (int q = 0; q < nt; ++q) {
      // the next step's costs, read before this step's results land
      float cn[kPer];
      if (q + 1 < nt) {
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          cn[k] = k < nvalid ? ld(at + dat + k * kstride) : 0.f;
      }
      scan_step<kPer>(prev, c, m, lane, g.D, nvalid, p1, p2);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (k < nvalid)
          st(at + k * kstride,
             kAcc == 2 ? prev[k] + ld(at + tile + k * kstride) : prev[k]);
        c[k] = cn[k];
      }
      at += dat;
    }
  }
}

// Store the scanned tile at `res` (the tile [s_lo, s_lo + nt) of the paths
// from `lo`) into `out`; with kAcc 1 each item is the second input's
// item at second(gi, si) plus the result, rounded as stored.
template <typename E, int kAcc, typename A>
__device__ __forceinline__ void store_tile(const Scan& g, const Part<E>& part,
                                           int lo, int s_lo, int nt,
                                           const E* res, E* out,
                                           A&& second) {
  if constexpr (std::is_same<E, float>::value) {
    if (g.vec) {
      for_tile(g, part, lo, s_lo, nt, [&](long long gi, int si) {
        float4 v = *reinterpret_cast<const float4*>(res + si);
        if (kAcc) {
          const float4 a = *reinterpret_cast<const float4*>(second(gi, si));
          v = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
        }
        *reinterpret_cast<float4*>(out + gi) = v;
      });
    } else {
      for_tile(g, part, lo, s_lo, nt, [&](long long gi, int si) {
        out[gi] = kAcc ? *second(gi, si) + res[si] : res[si];
      });
    }
  } else if (g.vec == 1) {
    for_tile(g, part, lo, s_lo, nt, [&](long long gi, int si) {
      uint4 v = *reinterpret_cast<const uint4*>(res + si);
      if (kAcc == 1) {
        const uint4 a = *reinterpret_cast<const uint4*>(second(gi, si));
        v = make_uint4(add2(a.x, v.x), add2(a.y, v.y), add2(a.z, v.z),
                       add2(a.w, v.w));
      }
      *reinterpret_cast<uint4*>(out + gi) = v;
    });
  } else if (g.vec == 2) {
    for_tile(g, part, lo, s_lo, nt, [&](long long gi, int si) {
      unsigned v = *reinterpret_cast<const unsigned*>(res + si);
      if (kAcc == 1)
        v = add2(*reinterpret_cast<const unsigned*>(second(gi, si)), v);
      *reinterpret_cast<unsigned*>(out + gi) = v;
    });
  } else {
    for_tile(g, part, lo, s_lo, nt, [&](long long gi, int si) {
      if (kAcc == 1)
        st(out + gi, ld(second(gi, si)) + ld(res + si));
      else
        out[gi] = res[si];
    });
  }
}

// One direction over the band blockIdx.y of `cost`: out = L, or with kAcc
// out = acc_in + L (acc_in may be out itself: a tile of it is read before
// that tile of out is written). kAcc 1 adds at the store, 2 (bfloat16
// only, vertical scans only) in the scan.
// (One block per SM is promised to the compiler, so that it may take up to
// 128 registers: with no promise it holds the kernels of 33-96 disparities
// to 64 registers and spills inside the scan loop, which cost the float32
// vertical scans at D = 80 up to 45 % on the H100. The shared memory, not
// the registers, decides how many blocks an SM holds.)
template <typename E, int kPer, int kAcc>
__global__ void __launch_bounds__(kTileThreads, 1)
sgm_tile_kernel(const E* __restrict__ cost, const E* acc_in, E* out, Scan g,
                float p1, float p2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* const smem = reinterpret_cast<E*>(smem_raw);
  constexpr bool kF32 = std::is_same<E, float>::value;
  const int tile = g.D * g.Sp;                   // elements of one tile
  const int slot = kAcc ? 2 * tile : tile;       // cost tile (+ acc_in tile)
  const int lo = blockIdx.x * g.P;
  const int ntiles = (g.S + g.T - 1) / g.T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;             // this warp's path
  const bool active =
      kScan && warp < g.P && lo + warp < g.span;  // warp-uniform
  const Part<E> part(g);
  const long long band = blockIdx.y * g.sB;
  cost += band;
  out += band;
  if (kAcc) acc_in += band;

  auto cbuf = [&](int j) { return smem + (j % kStages) * slot; };
  auto load = [&](int j) {
    if (!kCopy) return;
    int s_lo, nt;
    tile_range(g.S, g.T, g.reverse, j, s_lo, nt);
    E* c = cbuf(j);
    if (kF32 || g.vec) {
      for_tile(g, part, lo, s_lo, nt, [&](long long gi, int si) {
        cp_async(c + si, cost + gi, kF32 ? g.vec : g.vec == 1);
        if (kAcc)
          cp_async(c + tile + si, acc_in + gi, kF32 ? g.vec : g.vec == 1);
      });
    } else {
      for_tile(g, part, lo, s_lo, nt, [&](long long gi, int si) {
        c[si] = cost[gi];
        if (kAcc) c[tile + si] = acc_in[gi];
      });
    }
  };

  load(0);
  cp_async_commit();

  // this lane's disparities: d = lane + 32 k, valid for k < nvalid
  const int nvalid = (g.D - lane + 31) >> 5;
  float prev[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) prev[k] = 0.f;
  float m = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j landed; tile j - 1 is back in device memory
    if (j + 1 < ntiles) load(j + 1);
    cp_async_commit();

    int s_lo, nt;
    tile_range(g.S, g.T, g.reverse, j, s_lo, nt);
    if (active)
      scan_tile<E, kPer, kAcc>(g, cbuf(j), tile, nt, lane, warp, nvalid,
                               prev, m, p1, p2);
    __syncthreads();  // the tile's results are complete
    if (!kCopy) continue;
    const E* res = cbuf(j);
    store_tile<E, kAcc>(g, part, lo, s_lo, nt, res, out,
                        [&](long long, int si) { return res + tile + si; });
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// The deep horizontal form
// ---------------------------------------------------------------------------

constexpr int kDeepThreads = 256;  // 8 warps: P scan, the others copy
// 16-byte items of the second input a copying thread holds: a one-row
// block's share of a tile up to 1,120 planes (19 at 1,024), a two-row
// block's up to 480 (past that it reads them at the store). Holding 32
// took the accumulating kernels to 255 registers and spills (7.61 against
// 6.55 ms at (992, 512, 1536) on an H100); reading every item at the store
// instead was up to 8 % slower (kernel_ab.py --plans --deep).
constexpr int kDeepItems = 20;

// All of the block's threads meet here: the deep form's scanning and
// copying warps reach it from their own loops (a named barrier, not
// __syncthreads).
__device__ __forceinline__ void meet() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(blockDim.x) : "memory");
}

// a + v over 16 bytes: four float32 or eight bfloat16 adds, each rounded
template <typename E>
__device__ __forceinline__ uint4 add16(uint4 a, uint4 v) {
  if constexpr (std::is_same<E, float>::value)
    return make_uint4(
        __float_as_uint(__uint_as_float(a.x) + __uint_as_float(v.x)),
        __float_as_uint(__uint_as_float(a.y) + __uint_as_float(v.y)),
        __float_as_uint(__uint_as_float(a.z) + __uint_as_float(v.z)),
        __float_as_uint(__uint_as_float(a.w) + __uint_as_float(v.w)));
  else
    return make_uint4(add2(a.x, v.x), add2(a.y, v.y), add2(a.z, v.z),
                      add2(a.w, v.w));
}

// f(i, device index, shared index) for this thread's i-th item of the tile,
// i < N, as for_tile; N a compile-time bound, so that what f keeps per
// item can live in registers.
template <int N, typename E, typename F>
__device__ __forceinline__ void for_items(const Scan& g, const Part<E>& t,
                                          int lo, int s_lo, int nt, F&& f) {
  const int path = lo + t.p;
  if (t.ls >= nt || path >= g.span) return;
  const long long gi = t.d0 * g.sD + (long long)path * g.sL +
                       (long long)(s_lo + t.ls) * g.sS;
  const int si = t.d0 * g.Sp + t.off;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (t.d0 + i * t.dstep < g.D)
      f(i, gi + i * t.dstep * g.sD, si + i * t.dstep * g.Sp);
}

// One horizontal direction in blocks of P = 1 or 2 rows, for volumes whose
// 4-row tiles would hold runs of under 32 bytes (kernels.sgm_dir_plan).
// Warps 0 .. P-1 scan, one row each, and do nothing else; the other warps
// copy: while tile j is scanned they store tile j - 1 and load tile j + 1
// into the slot it leaves, so the ring holds the cost tiles alone. The
// second input (kAcc 1) is read from device memory in the store's own
// 16-byte items, one tile ahead into registers (a thread's items of a
// tile, at most kDeepItems; else at the store itself), and added there as
// sgm_tile_kernel adds it. acc_in may be out: each item is read and then
// written by the same thread.
template <typename E, int kPer, int kAcc>
__global__ void __launch_bounds__(kDeepThreads, 1)
sgm_tile_kernel_deep(const E* __restrict__ cost, const E* acc_in, E* out,
                     Scan g, float p1, float p2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* const smem = reinterpret_cast<E*>(smem_raw);
  constexpr bool kF32 = std::is_same<E, float>::value;
  const int tile = g.D * g.Sp;
  const int lo = blockIdx.x * g.P;
  const int ntiles = (g.S + g.T - 1) / g.T;
  const int warp = threadIdx.x >> 5;
  auto cbuf = [&](int j) { return smem + (j % kStages) * tile; };

  if (warp < g.P) {  // a scanning warp: meets the copying ones per tile
    const int lane = threadIdx.x & 31;
    const bool active = kScan && lo + warp < g.span;
    const int nvalid = (g.D - lane + 31) >> 5;
    float prev[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) prev[k] = 0.f;
    float m = 0.f;
    for (int j = 0; j < ntiles; ++j) {
      meet();  // tile j landed
      int s_lo, nt;
      tile_range(g.S, g.T, g.reverse, j, s_lo, nt);
      if (active)
        scan_tile<E, kPer, 0>(g, cbuf(j), tile, nt, lane, warp, nvalid,
                              prev, m, p1, p2);
    }
    meet();  // the last tile is scanned
    return;
  }

  const Part<E> part(g, threadIdx.x - 32 * g.P, blockDim.x - 32 * g.P);
  const long long band = blockIdx.y * g.sB;
  cost += band;
  out += band;
  if (kAcc) acc_in += band;
  const bool held = kAcc && g.vec == 1 &&
                    (g.D + part.dstep - 1) / part.dstep <= kDeepItems;
  uint4 pre[kDeepItems];  // the second input of the tile stored next

  auto load = [&](int j) {
    int s_lo, nt;
    tile_range(g.S, g.T, g.reverse, j, s_lo, nt);
    E* c = cbuf(j);
    if (kF32 || g.vec) {
      for_tile(g, part, lo, s_lo, nt, [&](long long gi, int si) {
        cp_async(c + si, cost + gi, kF32 ? g.vec : g.vec == 1);
      });
    } else {
      for_tile(g, part, lo, s_lo, nt,
               [&](long long gi, int si) { c[si] = cost[gi]; });
    }
  };

  if (kCopy) load(0);
  cp_async_commit();
  for (int j = 0; j <= ntiles; ++j) {
    cp_async_wait_all();
    meet();  // tile j landed; tile j - 1 is scanned
    if (!kCopy) continue;
    if (j > 0) {
      int s_lo, nt;
      tile_range(g.S, g.T, g.reverse, j - 1, s_lo, nt);
      const E* res = cbuf(j - 1);
      if (held) {
        for_items<kDeepItems>(g, part, lo, s_lo, nt,
                              [&](int i, long long gi, int si) {
          const uint4 v = *reinterpret_cast<const uint4*>(res + si);
          *reinterpret_cast<uint4*>(out + gi) = add16<E>(pre[i], v);
        });
      } else {
        store_tile<E, kAcc>(g, part, lo, s_lo, nt, res, out,
                            [&](long long gi, int) { return acc_in + gi; });
      }
    }
    // the slot is read above before the copies below refill it
    asm volatile("" ::: "memory");
    if (j + 1 < ntiles) load(j + 1);
    cp_async_commit();
    if (held && j < ntiles) {
      int s_lo, nt;
      tile_range(g.S, g.T, g.reverse, j, s_lo, nt);
      for_items<kDeepItems>(g, part, lo, s_lo, nt,
                            [&](int i, long long gi, int) {
        pre[i] = *reinterpret_cast<const uint4*>(acc_in + gi);
      });
    }
  }
}

template <typename E>
using TileKernel = void (*)(const E*, const E*, E*, Scan, float, float);

// The deep form is built for the disparities per lane that a deep plan
// can take (kernels.sgm_dir_plan): from 404 planes (13 per lane,
// accumulating).
template <int kPer>
constexpr bool kDeepBuilt = kBuilt<kPer> && kPer >= 13;

// The kernel for per = per_lane(D) disparities per lane, per <= kPer, the
// rule `mode` (kAcc above) for the second input, and the deep form or not;
// null where none is built.
template <typename E, int kPer, bool kDeep>
struct TileKernels {
  static TileKernel<E> get(int per, int mode) {
    if constexpr (kDeep) {
      if constexpr (kDeepBuilt<kPer>)
        if (per == kPer)
          return mode ? sgm_tile_kernel_deep<E, kPer, 1>
                      : sgm_tile_kernel_deep<E, kPer, 0>;
    } else if constexpr (kBuilt<kPer>) {
      if (per == kPer) {
        if constexpr (!std::is_same<E, float>::value)
          if (mode == 2) return sgm_tile_kernel<E, kPer, 2>;
        return mode ? sgm_tile_kernel<E, kPer, 1>
                    : sgm_tile_kernel<E, kPer, 0>;
      }
    }
    return TileKernels<E, kPer - 1, kDeep>::get(per, mode);
  }
};

template <typename E, bool kDeep>
struct TileKernels<E, 0, kDeep> {
  static TileKernel<E> get(int, int) { return nullptr; }
};

// Shared memory of one block: the ring of two tiles of D planes of
// paths * tile elements plus 16 bytes, twice that with a second input in
// the ring (its tile beside the cost tile; the deep form reads it from
// device memory instead).
inline long long tile_smem_bytes(int D, int paths, int tile, bool acc,
                                 int esize) {
  return (long long)kStages * D * (paths * tile + 16 / esize) *
         (acc ? 2 : 1) * esize;
}

template <typename E>
int launch_typed(const E* cost, const E* acc_in, E* out, Scan g, int bands,
                 float p1, float p2, void* stream) {
  const int esize = (int)sizeof(E);
  // horizontal blocks of 1 or 2 rows take the deep form
  const bool deep = g.horizontal && g.P < 4;
  const int threads = deep ? kDeepThreads : g.P * 32 > 256 ? g.P * 32 : 256;
  const int per = per_lane(g.D);
  const bool acc = acc_in != nullptr;
  const int mode = !acc ? 0 : (esize == 2 && g.once ? 2 : 1);
  const long long smem = tile_smem_bytes(g.D, g.P, g.T, acc && !deep, esize);
  if (per == 0 || g.S < 1 || g.span < 1 || bands < 1 ||
      bands > 65535 || !pow2(g.P) || (g.P < 4 && !deep) ||
      threads > kTileThreads || !pow2(g.T) || g.T > 32 ||
      g.P * g.T > threads || smem > kSmemMax || (mode == 2 && g.horizontal))
    return (int)cudaErrorInvalidValue;
  g.R = g.horizontal ? g.T : g.P;
  g.O = g.horizontal ? g.P : g.T;
  g.Sp = g.P * g.T + 16 / esize;
  const int w = g.vec == 1 ? 16 / esize : g.vec == 2 ? 2 : 1;
  if (g.vec < 0 || g.vec > (esize == 2 ? 2 : 1) || g.R % w)
    return (int)cudaErrorInvalidValue;
  const TileKernel<E> fn =
      deep ? TileKernels<E, kMaxPer, true>::get(per, mode)
           : TileKernels<E, kMaxPer, false>::get(per, mode);
  if (!fn) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(fn));
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((g.span + g.P - 1) / g.P, bands);
  fn<<<grid, threads, (size_t)smem, (cudaStream_t)stream>>>(cost, acc_in, out,
                                                            g, p1, p2);
  return (int)cudaGetLastError();
}

}  // namespace

int launch_tiles(const void* cost, const void* acc_in, void* out, Scan g,
                 int bands, float p1, float p2, void* stream) {
  if (g.bf16)
    return launch_typed(static_cast<const bf16*>(cost),
                        static_cast<const bf16*>(acc_in),
                        static_cast<bf16*>(out), g, bands, p1, p2, stream);
  return launch_typed(static_cast<const float*>(cost),
                      static_cast<const float*>(acc_in),
                      static_cast<float*>(out), g, bands, p1, p2, stream);
}

#endif  // SGM_TILE_KERNEL
