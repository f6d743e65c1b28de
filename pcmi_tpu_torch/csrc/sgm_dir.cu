// K1 sgm_dir: one semi-global aggregation direction over a (D, H, W)
// float32 or bfloat16 cost volume.
//
// Replaces: pcmi_tpu/ops/stereo/pallas_kernels.py, _dir_call_sub /
// _make_dir_kernel_sub / _step_sub (the TPU kernel scans an (S, Dp, B)
// transposed copy of the volume; this kernel reads (D, H, W) in place).
//
// The recurrence, the tile kernel and its design are in csrc/sgm_tile.cuh;
// this file points that kernel at a (D, H, W) volume. With -fmad=false the
// result is bit-identical to the plain PyTorch version
// (kernels.sgm_dir_plain).
//
// accumulate != 0 adds the direction into `out` (out = out + L) instead of
// storing it, so lr + rl and tb + bt each land in one volume with the
// reference's add grouping. In bfloat16 (the TPU kernel's stored dtype
// under cost_dtype="bfloat16") the costs are widened as they are read, the
// state stays float32 and L is rounded to nearest-even where it is stored;
// accumulating, the rounded L is added to the stored `out` and the sum
// rounded again: the bfloat16 add of two stored volumes that the
// reference's `lr + rl` is (csrc/sgm_tile.cuh).
//
// What bounds it: bytes. A launch reads the volume once and writes it once
// (2 x D*H*W elements of 4 or 2 bytes, 3x with accumulate); the recurrence is ~9 float
// operations per element, far below the card's rate. But each path is
// sequential along its scan axis and the card holds only H or W paths
// (~7-9 per SM), so the design keeps bytes in flight while every path
// waits on its previous step, and moves them in whole 16-byte vectors: a
// block holds P neighbouring paths (rows for horizontal scans, columns for
// vertical ones) and streams (D, P rows, T steps) or (D, T rows, P
// columns) tiles through the ring of sgm_tile.cuh, one warp per path.
//
// What holds it back on the H100 (kernel_ab.py --ablate times the tile
// copies alone and the scan alone): vertical scans of a few hundred
// columns fill ~100 SMs with blocks whose runs are only 32-64 bytes, so
// the copies alone stay near 60 % of the bound, and the scan of a tile,
// serial over its steps, overlaps them only in part. Horizontal scans
// come closer (runs of 64-128 bytes, 4 steps per shared-memory access).
// P and T come from the wrapper's launch plan (kernels.sgm_dir_plan).

#define SGM_TILE_KERNEL  // this source holds the tile kernel (also K5's)
#include "sgm_tile.cuh"

extern "C" int pcmi_sgm_dir_max_disp() { return 32 * kMaxPer; }

// cost, out: (D, H, W) float32, or bfloat16 with bf16 != 0, contiguous, on
// the current device.
// horizontal != 0 scans along W (L->R, or R->L with reverse), else along H
// (T->B, or B->T with reverse). The launch plan: blocks of `paths` paths
// (4, 8 or 16), tiles of `tile` steps (a power of 2 up to 32) that fit the
// shared memory. Returns a cudaError_t.
extern "C" int pcmi_sgm_dir(const void* cost, void* out, int D, int H,
                            int W, int horizontal, int reverse,
                            int accumulate, float p1, float p2, int paths,
                            int tile, int bf16, void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Scan g = {};
  g.D = D;
  g.S = horizontal ? W : H;
  g.span = horizontal ? H : W;
  g.sD = (long long)H * W;
  g.sS = horizontal ? 1 : W;
  g.sL = horizontal ? W : 1;
  g.horizontal = horizontal;
  g.reverse = reverse;
  g.T = tile;
  g.P = paths;
  g.bf16 = bf16;
  g.vec = copy_mode(bf16 ? 2 : 4, W, horizontal ? tile : paths, cost, out);
  return launch_tiles(cost, accumulate ? out : nullptr, out, g, 1, p1, p2,
                      stream);
}
