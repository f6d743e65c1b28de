// K1 sgm_dir: one semi-global aggregation direction over a (D, H, W)
// float32 cost volume.
//
// Replaces: pcmi_tpu/ops/stereo/pallas_kernels.py, _dir_call_sub /
// _make_dir_kernel_sub / _step_sub (the TPU kernel scans an (S, Dp, B)
// transposed copy of the volume; this kernel reads (D, H, W) in place).
//
// Recurrence (Hirschmueller 2008), state zero at the path start, float32:
//   L(p, d) = C(p, d) + min(L'(d), L'(d-1) + P1, L'(d+1) + P1, min L' + P2)
//             - min L'
// with "no neighbour" (1e9, as the reference's BIG padding) outside [0, D).
// Only adds and mins: with -fmad=false the result is bit-identical to the
// plain PyTorch version (kernels.sgm_dir_plain).
//
// accumulate != 0 adds the direction into `out` (out = out + L) instead of
// storing it, so lr + rl and tb + bt each land in one volume with the
// reference's add grouping.
//
// What bounds it: bytes. A launch reads the volume once and writes it once
// (2 x D*H*W*4 bytes, 3x with accumulate); the recurrence is ~9 float
// operations per element, far below the card's rate. But each path is
// sequential along its scan axis and the card holds only H or W paths
// (~7-9 per SM), so the design keeps bytes in flight while every path
// waits on its previous step, and moves them in whole 16-byte vectors:
//
// * A block holds P neighbouring paths (rows for horizontal scans, columns
//   for vertical ones) and streams the volume through shared memory in
//   tiles of T scan steps: a ring of two tiles, filled by 16-byte
//   cp.async.cg, so the next tile is in flight while the scan runs on the
//   current one (deeper rings measured no faster on the H100). Each copy
//   asks L2 for its whole 128-byte line, which the next tile (horizontal)
//   or the neighbouring block (vertical) reads soon after. For
//   accumulate the ring holds the tile of `out` beside the cost tile.
// * A tile keeps device memory's order: for each disparity a plane of O
//   runs of R consecutive x (horizontal: P rows of T steps; vertical: T
//   rows of P columns), so every copy and every store is a float4 of one
//   run, and a warp's copies cover whole 32-byte sectors. Planes lie
//   Sp floats apart (Sp = O*R + 4: Sp / 4 odd).
// * One warp per path; lane l holds the disparities d = l + 32k (k < kPer,
//   kPer = ceil(D / 32), a template parameter) in registers. The d +- 1
//   neighbours are 2 * kPer rotating shuffles per step, and the min over D
//   is one redux.sync on the floats' order-preserving integer images. The
//   scan reads a step's costs and writes its results in place, in the
//   tile. A horizontal path's tile is scanned 4 steps at a time, one
//   float4 per lane and disparity, free of bank conflicts (Sp / 4 odd); a
//   vertical one a step at a time, one float each, whose 32 lanes fall in
//   8 banks (4 ways), the price of the 16-byte copies. A scan step has no
//   block-wide barrier; a tile has two.
// * Rows that are not 16-byte aligned (W % 4 != 0, or an unaligned base)
//   take 4-byte copies and stores into the same layout, and are scanned
//   a step at a time.
//
// What holds it back on the H100 (kernel_ab.py --ablate times the tile
// copies alone and the scan alone): vertical scans of a few hundred
// columns fill ~100 SMs with blocks whose runs are only 32-64 bytes, so
// the copies alone stay near 60 % of the bound, and the scan of a tile,
// serial over its steps, overlaps them only in part. Horizontal scans
// come closer (runs of 64-128 bytes, 4 steps per shared-memory access).
// P and T come from the wrapper's launch plan (kernels.sgm_dir_plan).

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kMaxPer = 16;    // disparities per lane: D <= 512
constexpr float kBig = 1e9f;   // the reference's no-neighbour value
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 232448;  // dynamic shared memory of one block
constexpr int kMaxThreads = 512;
constexpr int kStages = 2;      // tiles in the ring

__device__ __forceinline__ void cp_async(float* dst, const float* src,
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

struct Scan {
  int D, S, span;
  long long sD, sS, sL;   // element strides: disparity, scan step, path
  int horizontal, reverse;
  int T, P;               // a tile's steps; a block's paths
  int R, O, Sp;           // a plane's runs of R floats, O runs, Sp apart
  int vec;                // 1: 16-byte copies and stores, else 4-byte
};

// The tile of scan-order steps [j*T, j*T + nt) covers the volume's steps
// [s_lo, s_lo + nt) in either direction.
__device__ __forceinline__ void tile_range(const Scan& g, int j, int& s_lo,
                                           int& nt) {
  const int t0 = j * g.T;
  nt = min(g.T, g.S - t0);
  s_lo = g.reverse ? g.S - t0 - nt : t0;
}

// One thread's share of a tile's copies and stores: the element (or the
// float4) at offset `off` of each plane d0, d0 + dstep, ...; `off` lies on
// path `p` (0 .. P-1) at step `ls` of the tile.
struct Part {
  int off, p, ls, d0, dstep;
  __device__ __forceinline__ explicit Part(const Scan& g) {
    const int w = g.vec ? 4 : 1;
    const int n = g.O * g.R / w;       // items of one plane (divides threads)
    off = (threadIdx.x % n) * w;
    const int o = off / g.R, r = off % g.R;
    p = g.horizontal ? o : r;
    ls = g.horizontal ? r : o;
    d0 = threadIdx.x / n;
    dstep = blockDim.x / n;
  }
};

// f(device index, shared index) for each of this thread's items of the
// tile [s_lo, s_lo + nt) of the paths from `lo`. An item lies wholly inside
// or wholly outside the volume (a float4 run starts at a multiple of 4).
template <typename F>
__device__ __forceinline__ void for_tile(const Scan& g, const Part& t,
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

// Floats as ints that order like the floats (NaN aside), so the warp's min
// is one redux instruction; the map is its own inverse.
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

__device__ __forceinline__ float& comp(float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 reversed(float4 v) {
  return make_float4(v.w, v.z, v.y, v.x);
}

template <int kPer, bool kAcc>
__global__ void __launch_bounds__(kMaxThreads)
sgm_dir_kernel(const float* __restrict__ cost, float* __restrict__ out,
               Scan g, float p1, float p2) {
  extern __shared__ __align__(16) float smem[];
  const int tile = g.D * g.Sp;                   // floats of one tile
  const int slot = kAcc ? 2 * tile : tile;       // cost tile (+ out tile)
  const int lo = blockIdx.x * g.P;
  const int ntiles = (g.S + g.T - 1) / g.T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;             // this warp's path
  const bool active = warp < g.P && lo + warp < g.span;  // warp-uniform
  const Part part(g);

  auto cbuf = [&](int j) { return smem + (j % kStages) * slot; };
  auto load = [&](int j) {
    int s_lo, nt;
    tile_range(g, j, s_lo, nt);
    float* c = cbuf(j);
    for_tile(g, part, lo, s_lo, nt, [&](long long gi, int si) {
      cp_async(c + si, cost + gi, g.vec);
      if (kAcc) cp_async(c + tile + si, out + gi, g.vec);
    });
  };

  load(0);
  cp_async_commit();

  // this lane's disparities: d = lane + 32 k, valid for k < nvalid
  const int nvalid = (g.D - lane + 31) >> 5;
  const int kstride = 32 * g.Sp;
  // horizontal tiles of whole float4 runs are scanned 4 steps at a time:
  // one 16-byte read and write per disparity, free of bank conflicts
  const bool by4 = g.horizontal && g.vec;
  // one scan step moves this many floats through the tile
  const int dat = (g.horizontal ? 1 : g.R) * (g.reverse ? -1 : 1);
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
    tile_range(g, j, s_lo, nt);
    if (active && by4) {
      float* row = cbuf(j) + lane * g.Sp + warp * g.R;
      for (int q = 0; q < nt; q += 4) {
        float4* at = reinterpret_cast<float4*>(
            row + (g.reverse ? nt - 4 - q : q));
        float4 cc[kPer];
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          cc[k] = k < nvalid ? at[k * (kstride / 4)] : make_float4(0, 0, 0, 0);
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
          if (k < nvalid) at[k * (kstride / 4)] = g.reverse ? reversed(cc[k]) : cc[k];
      }
    } else if (active) {
      const int ls0 = g.reverse ? nt - 1 : 0;
      float* at = cbuf(j) + lane * g.Sp +
                  (g.horizontal ? warp * g.R + ls0 : ls0 * g.R + warp);
      float c[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) c[k] = k < nvalid ? at[k * kstride] : 0.f;
      for (int q = 0; q < nt; ++q) {
        // the next step's costs, read before this step's results land
        float cn[kPer];
        if (q + 1 < nt) {
#pragma unroll
          for (int k = 0; k < kPer; ++k)
            cn[k] = k < nvalid ? at[dat + k * kstride] : 0.f;
        }
        scan_step<kPer>(prev, c, m, lane, g.D, nvalid, p1, p2);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (k < nvalid) at[k * kstride] = prev[k];
          c[k] = cn[k];
        }
        at += dat;
      }
    }
    __syncthreads();  // the tile's results are complete
    const float* res = cbuf(j);
    if (g.vec) {
      for_tile(g, part, lo, s_lo, nt, [&](long long gi, int si) {
        float4 v = *reinterpret_cast<const float4*>(res + si);
        if (kAcc) {
          const float4 a = *reinterpret_cast<const float4*>(res + tile + si);
          v = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
        }
        *reinterpret_cast<float4*>(out + gi) = v;
      });
    } else {
      for_tile(g, part, lo, s_lo, nt, [&](long long gi, int si) {
        out[gi] = kAcc ? res[tile + si] + res[si] : res[si];
      });
    }
  }
  cp_async_wait_all();
}

using KernelFn = void (*)(const float*, float*, Scan, float, float);

template <int kPer>
KernelFn pick(bool acc) {
  return acc ? sgm_dir_kernel<kPer, true> : sgm_dir_kernel<kPer, false>;
}

KernelFn kernel_for(int nper, bool acc) {
  switch (nper) {
    case 1: return pick<1>(acc);
    case 2: return pick<2>(acc);
    case 3: return pick<3>(acc);
    case 4: return pick<4>(acc);
    case 5: return pick<5>(acc);
    case 6: return pick<6>(acc);
    case 7: return pick<7>(acc);
    case 8: return pick<8>(acc);
    case 9: return pick<9>(acc);
    case 10: return pick<10>(acc);
    case 11: return pick<11>(acc);
    case 12: return pick<12>(acc);
    case 13: return pick<13>(acc);
    case 14: return pick<14>(acc);
    case 15: return pick<15>(acc);
    default: return pick<16>(acc);
  }
}

bool pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

// Shared memory of one block: the ring of two tiles of D planes of
// paths * tile + 4 floats, twice that with accumulate (the tile of `out`
// beside the cost tile).
long long smem_bytes(int D, int paths, int tile, int accumulate) {
  return (long long)kStages * D * (paths * tile + 4) * (accumulate ? 2 : 1) *
         (long long)sizeof(float);
}

}  // namespace

extern "C" int pcmi_sgm_dir_max_disp() { return 32 * kMaxPer; }

// cost, out: (D, H, W) float32, contiguous, on the current device.
// horizontal != 0 scans along W (L->R, or R->L with reverse), else along H
// (T->B, or B->T with reverse). The launch plan: blocks of `paths` paths
// (4, 8 or 16) and 8 warps or one warp per path, whichever is more; tiles
// of `tile` steps (a power of 2 up to 32) that fit the shared memory.
// Returns a cudaError_t.
extern "C" int pcmi_sgm_dir(const float* cost, float* out, int D, int H,
                            int W, int horizontal, int reverse,
                            int accumulate, float p1, float p2, int paths,
                            int tile, void* stream) {
  const int span = horizontal ? H : W;
  const int threads = paths * 32 > 256 ? paths * 32 : 256;
  const long long smem = smem_bytes(D, paths, tile, accumulate);
  if (D < 1 || D > 32 * kMaxPer || H < 1 || W < 1 || !pow2(paths) ||
      paths < 4 || paths > 16 || !pow2(tile) || tile > 32 ||
      paths * tile > threads || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int nper = (D + 31) / 32;
  const KernelFn fn = kernel_for(nper, accumulate != 0);
  // above 48 KB only after opting in, once per kernel
  static bool opted_in[kMaxPer][2] = {};
  bool& done = opted_in[nper - 1][accumulate != 0];
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  Scan g;
  g.D = D;
  g.S = horizontal ? W : H;
  g.span = span;
  g.sD = (long long)H * W;
  g.sS = horizontal ? 1 : W;
  g.sL = horizontal ? W : 1;
  g.horizontal = horizontal;
  g.reverse = reverse;
  g.T = tile;
  g.P = paths;
  g.R = horizontal ? tile : paths;
  g.O = horizontal ? paths : tile;
  g.Sp = paths * tile + 4;
  g.vec = W % 4 == 0 && g.R % 4 == 0 &&
          reinterpret_cast<size_t>(cost) % 16 == 0 &&
          reinterpret_cast<size_t>(out) % 16 == 0;
  const int blocks = (span + paths - 1) / paths;
  fn<<<blocks, threads, (size_t)smem, (cudaStream_t)stream>>>(cost, out, g,
                                                                 p1, p2);
  return (int)cudaGetLastError();
}
