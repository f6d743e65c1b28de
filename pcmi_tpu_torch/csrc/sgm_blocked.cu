// K5 sgm_blocked: one semi-global aggregation direction over a blocked
// (nb, S, Dp, 128) float32 or bfloat16 volume (bands of 128 contiguous
// lanes), with an optional second input added to the output.
//
// Replaces: pcmi_tpu/ops/stereo/pallas_kernels.py, _blocked_dir_sum /
// _make_blocked_kernel (grid (bands, chunks), the state carried in VMEM
// scratch across the sequential chunk axis; with_prev adds the forward
// pass into the backward pass's output, so both directions cost three
// volume passes).
//
// Recurrence and grouping as K1, state zero at the path start, "no
// neighbour" (1e9) outside [0, Dp); with `prev` the output is L + prev. In
// bfloat16 the state stays float32 and the output is rounded once where it
// is stored: with `prev`, from the float32 sum of the state and `prev`, as
// the TPU kernel stores `(st + prev)` (K1's accumulate rounds L first: the
// two rules differ, csrc/sgm_tile.cuh holds both).
// With -fmad=false the result is bit-identical to the plain PyTorch
// version (kernels.sgm_blocked_plain).
//
// This is K1's tile kernel (csrc/sgm_tile.cuh, compiled in csrc/sgm_dir.cu
// and called from here through launch_tiles) pointed at the blocked
// layout: a band is a volume of 128 paths whose disparities lie 128 floats
// apart, whose scan steps lie Dp * 128 apart and whose paths are
// neighbours in memory, and the bands are the grid's second axis. A block
// takes P neighbouring lanes of one band, one warp per lane of the band,
// and streams (T steps, Dp, P) tiles through the two-tile cp.async ring;
// `prev` rides the ring beside the cost tile as K1's accumulate input
// does. A band's 128 lanes are contiguous and 16-byte aligned, so every
// copy and store is 16 bytes (4 float32 or 8 bfloat16).
//
// What bounds it: bytes (2 volumes per launch, 3 with `prev`), as K1's
// vertical scans: nb * 128 paths, each sequential over S. P and T come
// from the wrapper's launch plan (kernels.sgm_blocked_plan): wider blocks
// move longer runs (P * 4 bytes per disparity and step) but leave fewer
// blocks than the card has SMs. On the H100 8 lanes win at 7 bands, 16 at
// 9 bands, and blocks of 32 lanes (1024 threads) lost at both, so the
// kernel takes 8 or 16.

#include "sgm_tile.cuh"

namespace {
constexpr int kBand = 128;     // lanes per band (the layout's minor axis)
}  // namespace

extern "C" int pcmi_sgm_blocked_max_disp() { return 32 * kMaxPer; }

// cost, out (and prev, which may be null): (nb, S, Dp, 128) float32, or
// bfloat16 with bf16 != 0, contiguous, 16-byte aligned, on the current device. Scans S forward, or
// backward with reverse; out = L, or L + prev. The launch plan: blocks of
// `paths` lanes of a band (8 or 16), tiles of `tile` steps (a power of 2)
// that fit the shared memory. Returns a cudaError_t.
extern "C" int pcmi_sgm_blocked(const void* cost, const void* prev,
                                void* out, int nb, int S, int Dp, float p1,
                                float p2, int reverse, int paths, int tile,
                                int bf16, void* stream) {
  if (paths < 8 || paths > 16 || !aligned16(cost) || !aligned16(out) ||
      !aligned16(prev))
    return (int)cudaErrorInvalidValue;
  Scan g = {};
  g.D = Dp;
  g.S = S;
  g.span = kBand;
  g.sD = kBand;
  g.sS = (long long)Dp * kBand;
  g.sL = 1;
  g.sB = (long long)S * Dp * kBand;
  g.horizontal = 0;
  g.reverse = reverse;
  g.T = tile;
  g.P = paths;
  g.bf16 = bf16;
  g.once = 1;
  g.vec = 1;
  return launch_tiles(cost, prev, out, g, nb, p1, p2, stream);
}
