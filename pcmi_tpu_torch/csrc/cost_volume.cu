// K7 cost_volume and the census transform: the matcher's box-aggregated
// census+AD matching cost, built on the card.
//
// Replaces: no TPU kernel. The reference builds the volume in XLA
// (pcmi_tpu/ops/stereo/matching.py, build_cost_volume); the port's plain
// version (ops/stereo/kernels.cost_volume_plain) runs ~50 PyTorch
// operations per 16-disparity chunk, each of which writes a (16, H, W)
// temporary, and its census transform ~5 per neighbour bit.
//
// census_kernel: one thread per pixel, `window`^2 - 1 neighbour bits at
// edge-clamped coordinates (the plain version's replicate padding),
// `neighbour < centre` each, in row-major order of the window without its
// centre: bits 0-23 into the first int32 plane, the rest into the second.
// The same bits as the plain version.
//
// K7 (cost_volume_box_kernel, cost_volume_kernel): one block takes a tile
// of output pixels for a group of 16 disparities, and for each disparity d:
//   1. the raw cost of the tile and its halo (k - 1 rows and columns, k =
//      the block size) into shared memory, at edge-clamped coordinates,
//      which equals the plain version's replicate padding of the cost
//      plane: 1.0 where the left pixel or the right pixel (y, x - d) is
//      invalid or x - d lies outside [0, W) (the plain version pads the
//      right view's `valid` with 0), else
//        table[popc(l0 ^ r0) + popc(l1 ^ r1)] + w_ad * ad,
//        ad = min(|l - r|, 0.5) * 2,
//      where table[h] is (1 - ad_weight) * (h / n_census) as PyTorch
//      computes it on the same device (ops/stereo/kernels.py makes it
//      with the plain version's own two operations);
//   2. the rows' sliding sums of length k with _sliding_sum's tree and
//      add order: s_{2w}[i] = s_w[i] + s_w[i + w], and the sum of k is the
//      levels of k's set bits added from the largest, each at the offset
//      the larger ones left (k = 15: s8[i] + s4[i+8] + s2[i+12] +
//      s1[i+14]); then times 1/k;
//   3. the same along the columns of that result, times 1/k, and one
//      store of the tile's (d, y, x) elements in float32 or rounded once to
//      bfloat16 (nearest-even).
// The arithmetic is the plain version's on the card, operation for
// operation, each result rounded to float32 (-fmad=false keeps every
// product and sum apart): PyTorch's CUDA division of a float32 tensor by
// a Python number is the product with the float32 reciprocal, so the box
// means are `sum * (1.0f / k)` and the AD term's division by 0.5 a
// product with 2 (exact); the blend adds the two weighted terms as two
// products. The result is the plain version's, bit for bit.
//
// Two forms of one algorithm, chosen by the block size:
//   - the box form (odd k up to 15, the matcher's sizes: 15 for the main
//     volume, 3 for the census checker, 1 for the vertical one): k is a
//     template argument, so steps 2 and 3 run in registers on compile-time
//     indices (below);
//   - the generic form (any other k): each level of steps 2 and 3 is a
//     pass over shared memory by all threads with a barrier after it.
//
// What bounds it: the volume's one write (D*H*W elements of 4 or 2
// bytes), 0.28 ms for (288, 896, 896) in float32. It runs at 2.0 ms there
// (box form, k = 15; CUDA events, H100): step 1 takes most of it, eight
// loads of the (H, W) input planes through L1 and L2 for each raw cost,
// since a block's tile of inputs (~26 bytes a pixel, both views) does not
// fit in its share of L1; k = 3 costs nearly as much (1.6 ms). The box
// form reads the left pixel once for two disparities and issues every
// load before using any; more disparities per pass, other tiles and one
// raw pass per disparity measured slower (PERF.md, PR 19).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32;        // threads along x: one warp per row
constexpr int kTy = 8;         // rows of threads
constexpr int kTable = 49;     // census costs of Hamming distances 0..48
constexpr int kTablePad = 64;  // floats the table takes in shared memory
constexpr int kSmemMax = 232448;  // shared memory one block may use

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(kTx * kTy)
    census_kernel(const float* __restrict__ img, int* __restrict__ bits0,
                  int* __restrict__ bits1, int H, int W, int window) {
  const int x = blockIdx.x * kTx + threadIdx.x;
  const int y = blockIdx.y * kTy + threadIdx.y;
  if (x >= W || y >= H) return;
  const int r = window / 2;
  const long long at = (long long)y * W + x;
  const float c = img[at];
  unsigned lo = 0, hi = 0;
  int idx = 0;
  for (int dy = 0; dy < window; ++dy) {
    const float* row = img + (long long)clampi(y + dy - r, 0, H - 1) * W;
    for (int dx = 0; dx < window; ++dx) {
      if (dy == r && dx == r) continue;
      const unsigned bit = __ldg(row + clampi(x + dx - r, 0, W - 1)) < c;
      if (idx < 24)
        lo |= bit << idx;
      else
        hi |= bit << (idx - 24);
      ++idx;
    }
  }
  bits0[at] = (int)lo;
  bits1[at] = (int)hi;
}

// The inputs of one volume: (H, W) planes, contiguous.
struct Planes {
  const float* left;
  const int* l0;
  const int* l1;
  const unsigned char* vl;   // left validity, 0 or 1
  const float* right;
  const int* r0;
  const int* r1;
  const unsigned char* vr;   // right validity, 0 or not
  const float* table;        // kTable census costs, already weighted
};

struct Shape {
  int D, H, W, d_min, stride;
  int k, levels;             // block size, floor(log2 k) + 1
  int th, tw, ew;            // tile rows and columns, haloed columns
  int group;                 // disparities per block
  float w_ad, inv_k;
  bool vec;                  // 16-byte stores of 8 outputs (box form)
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The sum of k consecutive elements from the levels at `lv` (level l at
// lv + l * pitch, consecutive elements `step` apart): the levels of k's
// set bits, from the largest, each at the offset the larger ones left.
__device__ __forceinline__ float tree_sum(const float* lv, long long pitch,
                                          int step, int k, int levels) {
  float acc = 0.0f;
  bool first = true;
  int off = 0;
  for (int l = levels - 1; l >= 0; --l) {
    const int w = 1 << l;
    if (k & w) {
      const float s = lv[l * pitch + off * step];
      acc = first ? s : acc + s;
      first = false;
      off += w;
    }
  }
  return acc;
}

// The raw cost at (row `base` / W, column x) for disparity d: 1.0 where
// either pixel is invalid or x - d lies outside [0, W).
__device__ __forceinline__ float raw_cost(const Planes& p, const Shape& s,
                                          const float* table, long long base,
                                          int x, int d) {
  const int xr = x - d;
  if (xr < 0 || xr >= s.W || !__ldg(p.vl + base + x) ||
      !__ldg(p.vr + base + xr))
    return 1.0f;
  const int ham =
      __popc(__ldg(p.l0 + base + x) ^ __ldg(p.r0 + base + xr)) +
      __popc(__ldg(p.l1 + base + x) ^ __ldg(p.r1 + base + xr));
  const float diff =
      fabsf(__ldg(p.left + base + x) - __ldg(p.right + base + xr));
  const float ad = (diff > 0.5f ? 0.5f : diff) * 2.0f;
  return table[min(ham, kTable - 1)] + s.w_ad * ad;
}

// The raw costs at (row `base` / W, column x) for the n disparities d0,
// d0 + stride, ... into out[b * pitch]: raw_cost's values, with the left
// pixel read once and every load issued up front (columns clamped into
// the image; the masks decide).
template <int N>
__device__ __forceinline__ void raw_costs(const Planes& p, const Shape& s,
                                          const float* table, long long base,
                                          int x, int d0, float* out,
                                          int pitch) {
  const long long at = base + x;
  const bool vl = __ldg(p.vl + at);
  const int l0 = __ldg(p.l0 + at), l1 = __ldg(p.l1 + at);
  const float lv = __ldg(p.left + at);
  bool in[N];
  int r0[N], r1[N];
  float rv[N];
#pragma unroll
  for (int b = 0; b < N; ++b) {
    const int xr = x - (d0 + b * s.stride);
    const long long q = base + clampi(xr, 0, s.W - 1);
    const bool vr = __ldg(p.vr + q) != 0;
    in[b] = (xr >= 0) & (xr < s.W) & vl & vr;
    r0[b] = __ldg(p.r0 + q);
    r1[b] = __ldg(p.r1 + q);
    rv[b] = __ldg(p.right + q);
  }
#pragma unroll
  for (int b = 0; b < N; ++b) {
    const int ham = __popc(l0 ^ r0[b]) + __popc(l1 ^ r1[b]);
    const float diff = fabsf(lv - rv[b]);
    const float ad = (diff > 0.5f ? 0.5f : diff) * 2.0f;
    out[b * pitch] =
        in[b] ? table[min(ham, kTable - 1)] + s.w_ad * ad : 1.0f;
  }
}

// The generic form, for any block size: levels in shared memory.
template <typename E>
__global__ void __launch_bounds__(kTx * kTy)
    cost_volume_kernel(Planes p, Shape s, E* __restrict__ out) {
  extern __shared__ float smem[];
  float* table = smem;
  float* lv = smem + kTablePad;          // the levels, log2(k) + 1 planes
  const int eh = s.th + s.k - 1, ew = s.ew;
  const int plane = eh * ew;             // one vertical level
  const int hplane = s.th * ew;          // one horizontal level
  float* vbox = lv + s.levels * plane;   // the rows' means, th x ew
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty * kTx + tx; i < kTable; i += kTx * kTy)
    table[i] = p.table[i];
  const int r = s.k / 2;
  const int ox = blockIdx.x * s.tw, oy = blockIdx.y * s.th;
  const int i0 = blockIdx.z * s.group;
  const int i1 = min(i0 + s.group, s.D);
  __syncthreads();

  for (int i = i0; i < i1; ++i) {
    const int d = s.d_min + i * s.stride;
    // 1. raw costs of the haloed tile
    for (int row = ty; row < eh; row += kTy) {
      const long long base =
          (long long)clampi(oy - r + row, 0, s.H - 1) * s.W;
      for (int col = tx; col < ew; col += kTx) {
        lv[row * ew + col] =
            raw_cost(p, s, table, base, clampi(ox - r + col, 0, s.W - 1), d);
      }
    }
    __syncthreads();
    // 2. the rows' levels, then their sums of k and means
    int rows = eh;
    for (int l = 1; l < s.levels; ++l) {
      const int w = 1 << (l - 1);
      rows -= w;
      const float* a = lv + (l - 1) * plane;
      float* b = lv + l * plane;
      for (int row = ty; row < rows; row += kTy)
        for (int col = tx; col < ew; col += kTx)
          b[row * ew + col] = a[row * ew + col] + a[(row + w) * ew + col];
      __syncthreads();
    }
    for (int row = ty; row < s.th; row += kTy)
      for (int col = tx; col < ew; col += kTx)
        vbox[row * ew + col] =
            tree_sum(lv + row * ew + col, plane, ew, s.k, s.levels) *
            s.inv_k;
    __syncthreads();
    // 3. the columns' levels (level 0 is vbox, level l lies at
    // vbox - l * hplane, over the rows' planes), their sums of k and
    // means, stored
    int cols = ew;
    for (int l = 1; l < s.levels; ++l) {
      const int w = 1 << (l - 1);
      cols -= w;
      const float* a = vbox - (l - 1) * hplane;
      float* b = vbox - l * hplane;
      for (int row = ty; row < s.th; row += kTy)
        for (int col = tx; col < cols; col += kTx)
          b[row * ew + col] = a[row * ew + col] + a[row * ew + col + w];
      __syncthreads();
    }
    E* o = out + (long long)i * s.H * s.W;
    for (int row = ty; row < s.th; row += kTy) {
      const int y = oy + row;
      if (y >= s.H) break;
      for (int col = tx; col < s.tw; col += kTx) {
        const int x = ox + col;
        if (x >= s.W) break;
        store(o + (long long)y * s.W + x,
              tree_sum(vbox + row * ew + col, -(long long)hplane, 1, s.k,
                       s.levels) *
                  s.inv_k);
      }
    }
    __syncthreads();  // the next disparity's raw costs overwrite the levels
  }
}

// s_W[j] of _sliding_sum's tree over v: s_1[j] = v[j],
// s_{2w}[j] = s_w[j] + s_w[j + w]. Unrolled with constant indices, the
// compiler shares the subtrees the sums of neighbouring outputs have in
// common (the same adds of the same operands).
template <int W, int N>
__device__ __forceinline__ float level(const float (&v)[N], int j) {
  if constexpr (W == 1)
    return v[j];
  else
    return level<W / 2>(v, j) + level<W / 2>(v, j + W / 2);
}

// The sum of K consecutive elements of v from i: the levels of K's set
// bits from the largest (W), each at the offset the larger ones left.
template <int K, int W, int N>
__device__ __forceinline__ float box_sum(const float (&v)[N], int i, int off,
                                         float acc) {
  if constexpr (W == 0) {
    return acc;
  } else if constexpr ((K & W) != 0) {
    const float t = level<W>(v, i + off);
    return box_sum<K, W / 2>(v, i, off + W, K < 2 * W ? t : acc + t);
  } else {
    return box_sum<K, W / 2>(v, i, off, acc);
  }
}

constexpr int top_bit(int k) { return k < 2 ? k : 2 * top_bit(k / 2); }

// The form of the odd block sizes up to 15: tiles of 32 x 128 outputs;
// the haloed raw costs of kNB disparities in shared memory at once (the
// left pixel read once for them, the right pixels of the next disparity
// one column over, in L1), then for each disparity both means in
// registers, with one barrier after each of the two passes:
//   rows: a thread takes one haloed column and kRV outputs, loads their
//   kRV + K - 1 raw costs and writes kRV means of the rows into V;
//   columns: a thread takes one row and kRH outputs (a warp 32 rows of one
//   span, so with V's odd pitch its loads hit 32 banks), loads kRH + K - 1
//   means and stores kRH outputs, as 16-byte vectors where the rows allow.
constexpr int kBoxTH = 32, kBoxTW = 128, kRV = 8, kRH = 8, kNB = 2;

template <int K>
struct Box {
  static constexpr int kEH = kBoxTH + K - 1;   // haloed rows
  static constexpr int kEW = kBoxTW + K - 1;   // haloed columns
  static constexpr int kVP = kEW | 1;          // V's pitch, odd
  static constexpr int kTop = top_bit(K);
  static constexpr size_t kSmem =
      4 * (kTablePad + (size_t)kNB * kEH * kEW + (size_t)kBoxTH * kVP);
};

template <typename E>
__device__ __forceinline__ void store8(E* o, const float (&v)[kRH], int n,
                                       bool vec);

template <>
__device__ __forceinline__ void store8(float* o, const float (&v)[kRH], int n,
                                       bool vec) {
  if (vec && n == kRH) {
    reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kRH; ++j)
    if (j < n) o[j] = v[j];
}

template <>
__device__ __forceinline__ void store8(__nv_bfloat16* o,
                                       const float (&v)[kRH], int n,
                                       bool vec) {
  if (vec && n == kRH) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // element 2j in the low half: the lower address
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kRH; ++j)
    if (j < n) o[j] = __float2bfloat16_rn(v[j]);
}

template <int K, typename E>
__global__ void __launch_bounds__(kTx * kTy)
    cost_volume_box_kernel(Planes p, Shape s, E* __restrict__ out) {
  using B = Box<K>;
  extern __shared__ float smem[];
  float* table = smem;
  float* raw = smem + kTablePad;           // kNB planes of kEH x kEW
  float* vm = raw + kNB * B::kEH * B::kEW;  // kBoxTH x kVP: rows' means
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTx + tx;
  for (int i = tid; i < kTable; i += kTx * kTy) table[i] = p.table[i];
  constexpr int r = K / 2;
  const int ox = blockIdx.x * kBoxTW, oy = blockIdx.y * kBoxTH;
  const int i0 = blockIdx.z * s.group;
  const int i1 = min(i0 + s.group, s.D);
  __syncthreads();

  for (int i = i0; i < i1; i += kNB) {
    const int nb = min(kNB, i1 - i);
    // raw costs of the haloed tile for kNB disparities: the left pixel
    // read once, every load issued before any is used
    for (int row = ty; row < B::kEH; row += kTy) {
      const long long base =
          (long long)clampi(oy - r + row, 0, s.H - 1) * s.W;
      for (int col = tx; col < B::kEW; col += kTx)
        raw_costs<kNB>(p, s, table, base, clampi(ox - r + col, 0, s.W - 1),
                       s.d_min + i * s.stride, raw + row * B::kEW + col,
                       B::kEH * B::kEW);
    }
    __syncthreads();
    for (int b = 0; b < nb; ++b) {
      const float* rb = raw + b * B::kEH * B::kEW;
      // the rows' means: (strip, haloed column) items
      for (int it = tid; it < (kBoxTH / kRV) * B::kEW; it += kTx * kTy) {
        const int col = it % B::kEW, row0 = (it / B::kEW) * kRV;
        float v[kRV + K - 1];
#pragma unroll
        for (int j = 0; j < kRV + K - 1; ++j)
          v[j] = rb[(row0 + j) * B::kEW + col];
#pragma unroll
        for (int j = 0; j < kRV; ++j)
          vm[(row0 + j) * B::kVP + col] =
              box_sum<K, B::kTop>(v, j, 0, 0.0f) * s.inv_k;
      }
      __syncthreads();
      // the columns' means, stored: (row, span) items, a warp 32 rows
      E* o = out + (long long)(i + b) * s.H * s.W;
      for (int it = tid; it < kBoxTH * (kBoxTW / kRH); it += kTx * kTy) {
        const int row = it % kBoxTH, col0 = (it / kBoxTH) * kRH;
        const int y = oy + row, x0 = ox + col0;
        if (y >= s.H || x0 >= s.W) continue;
        float v[kRH + K - 1];
#pragma unroll
        for (int j = 0; j < kRH + K - 1; ++j)
          v[j] = vm[row * B::kVP + col0 + j];
        float m[kRH];
#pragma unroll
        for (int j = 0; j < kRH; ++j)
          m[j] = box_sum<K, B::kTop>(v, j, 0, 0.0f) * s.inv_k;
        store8(o + (long long)y * s.W + x0, m, min(kRH, s.W - x0), s.vec);
      }
      // `vm` is rewritten after the next barrier: the next plane's rows
      // follow it, and so do the next raw costs, whose barrier comes first
      __syncthreads();
    }
  }
}

template <int K, typename E>
cudaError_t launch_box(const Planes& p, const Shape& s, E* out,
                       cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(cost_volume_box_kernel<K, E>);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Box<K>::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.W + kBoxTW - 1) / kBoxTW, (s.H + kBoxTH - 1) / kBoxTH,
                  (s.D + s.group - 1) / s.group);
  cost_volume_box_kernel<K, E>
      <<<grid, dim3(kTx, kTy), Box<K>::kSmem, stream>>>(p, s, out);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_box_any(const Planes& p, const Shape& s, E* out,
                           cudaStream_t stream) {
  switch (s.k) {
    case 1: return launch_box<1>(p, s, out, stream);
    case 3: return launch_box<3>(p, s, out, stream);
    case 5: return launch_box<5>(p, s, out, stream);
    case 7: return launch_box<7>(p, s, out, stream);
    case 9: return launch_box<9>(p, s, out, stream);
    case 11: return launch_box<11>(p, s, out, stream);
    case 13: return launch_box<13>(p, s, out, stream);
    case 15: return launch_box<15>(p, s, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename E>
cudaError_t launch_volume(const Planes& p, const Shape& s, E* out,
                          size_t smem, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(cost_volume_kernel<E>);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.W + s.tw - 1) / s.tw, (s.H + s.th - 1) / s.th,
                  (s.D + s.group - 1) / s.group);
  cost_volume_kernel<E><<<grid, dim3(kTx, kTy), smem, stream>>>(p, s, out);
  return cudaGetLastError();
}

}  // namespace

// img: (H, W) float32; bits0, bits1: (H, W) int32; all contiguous.
// window odd in [3, 7]. Returns a cudaError_t.
extern "C" int pcmi_census(const void* img, void* bits0, void* bits1, int H,
                           int W, int window, void* stream) {
  if (H < 1 || W < 1 || window < 3 || window > 7 || window % 2 == 0 ||
      H > 65535 * kTy)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTx - 1) / kTx, (H + kTy - 1) / kTy);
  census_kernel<<<grid, dim3(kTx, kTy), 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(img), static_cast<int*>(bits0),
      static_cast<int*>(bits1), H, W, window);
  return (int)cudaGetLastError();
}

// left, right: (H, W) float32; l0, l1, r0, r1: (H, W) int32 census planes;
// vl, vr: (H, W) bytes, nonzero where valid; table: 49 float32 census
// costs; out: (D, H, W) float32, or bfloat16 with bf16 != 0. Plane i holds
// disparity d_min + i * stride. The launch plan (cost_volume_plan in
// ops/stereo/kernels.py): for the odd block sizes up to 15 the box form's
// tiles of 32 x 128 outputs; for the others the generic form's tiles of
// tile_h x tile_w (tile_w + block - 1 a multiple of 32); `group`
// disparities per block. Returns a cudaError_t.
extern "C" int pcmi_cost_volume(const void* left, const void* l0,
                                const void* l1, const void* vl,
                                const void* right, const void* r0,
                                const void* r1, const void* vr,
                                const void* table, void* out, int D, int H,
                                int W, int d_min, int stride, int block,
                                float w_ad, int tile_h, int tile_w, int group,
                                int bf16, void* stream) {
  if (D < 1 || H < 1 || W < 1 || block < 1 || tile_h < 1 || tile_w < 1 ||
      group < 1 || (D + group - 1) / group > 65535 ||
      (H + tile_h - 1) / tile_h > 65535)
    return (int)cudaErrorInvalidValue;
  Shape s = {};
  s.D = D;
  s.H = H;
  s.W = W;
  s.d_min = d_min;
  s.stride = stride;
  s.k = block;
  while ((1 << s.levels) <= block) ++s.levels;
  s.th = tile_h;
  s.tw = tile_w;
  s.ew = tile_w + block - 1;
  s.group = group;
  s.w_ad = w_ad;
  s.inv_k = 1.0f / (float)block;
  s.vec = W % 8 == 0 && reinterpret_cast<size_t>(out) % 16 == 0;
  const Planes p = {static_cast<const float*>(left),
                    static_cast<const int*>(l0),
                    static_cast<const int*>(l1),
                    static_cast<const unsigned char*>(vl),
                    static_cast<const float*>(right),
                    static_cast<const int*>(r0),
                    static_cast<const int*>(r1),
                    static_cast<const unsigned char*>(vr),
                    static_cast<const float*>(table)};
  const cudaStream_t st = (cudaStream_t)stream;
  if (block % 2 == 1 && block <= 15) {
    if (tile_h != kBoxTH || tile_w != kBoxTW) return (int)cudaErrorInvalidValue;
    if (bf16)
      return (int)launch_box_any(p, s, static_cast<__nv_bfloat16*>(out), st);
    return (int)launch_box_any(p, s, static_cast<float*>(out), st);
  }
  // the table, the rows' levels and their means (cost_volume_smem in
  // ops/stereo/kernels.py)
  const long long smem =
      4LL * (kTablePad + (long long)s.levels * (tile_h + block - 1) * s.ew +
             (long long)tile_h * s.ew);
  if (smem > kSmemMax || s.ew % kTx != 0) return (int)cudaErrorInvalidValue;
  if (bf16)
    return (int)launch_volume(p, s, static_cast<__nv_bfloat16*>(out),
                              (size_t)smem, st);
  return (int)launch_volume(p, s, static_cast<float*>(out), (size_t)smem, st);
}
