"""The port's package boundary and kernel plumbing (no card needed)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pcmi_tpu_torch.ops.stereo import _build
from pcmi_tpu_torch.ops.stereo import kernels as K

torch.set_num_threads(1)

PKG = Path(__file__).resolve().parents[1] / "pcmi_tpu_torch"
MODULES = [
    "pcmi_tpu_torch", "pcmi_tpu_torch.config", "pcmi_tpu_torch.convert",
    "pcmi_tpu_torch.pipelines.height_map",
    "pcmi_tpu_torch.ops.stereo.matching", "pcmi_tpu_torch.ops.stereo._build",
    "pcmi_tpu_torch.ops.stereo.layouts",
    "pcmi_tpu_torch.geometry.synthetic",
    # the fusion slice
    "pcmi_tpu_torch.geometry.pairs", "pcmi_tpu_torch.ops.segmented",
    "pcmi_tpu_torch.ops.pointcloud", "pcmi_tpu_torch.utils.cache",
    "pcmi_tpu_torch.parallel.stereo_sharded",
    "pcmi_tpu_torch.pipelines.streaming", "pcmi_tpu_torch.pipelines.multiday",
    "pcmi_tpu_torch.pipelines.evaluation", "pcmi_tpu_torch.pipelines",
    # the banded and hierarchical matchers, the modules finished beside
    # them and the packages' exports
    "pcmi_tpu_torch.ops.stereo.banded", "pcmi_tpu_torch.ops.stereo.hierarchical",
    "pcmi_tpu_torch.ops.stereo.numpy_ref", "pcmi_tpu_torch.ops.morphology",
    "pcmi_tpu_torch.ops.filters", "pcmi_tpu_torch.ops.warp",
    "pcmi_tpu_torch.geometry.rpc", "pcmi_tpu_torch.geometry.affine",
    "pcmi_tpu_torch.geometry.rectify", "pcmi_tpu_torch.utils.profiling",
    "pcmi_tpu_torch.utils.visualize", "pcmi_tpu_torch.ops",
    "pcmi_tpu_torch.ops.stereo", "pcmi_tpu_torch.utils",
]


def test_pipelines_exports():
    import pcmi_tpu.pipelines as ref
    import pcmi_tpu_torch.pipelines as port

    for name in ("HeightMapPipeline", "MultiDayFusion",
                 "StreamingAOIPipeline"):
        assert hasattr(ref, name) and hasattr(port, name), name


_NO_REFERENCE = (
    "import sys\n"
    "assert 'jax' not in sys.modules, 'jax imported'\n"
    "ref = sorted(m for m in sys.modules\n"
    "             if m == 'pcmi_tpu' or m.startswith('pcmi_tpu.'))\n"
    "assert not ref, ref\n")


def _run_fresh(code: str) -> None:
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=PKG.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_import_leaves_jax_out():
    """Every port module imports neither JAX nor any module of the
    reference package, not even its JAX-free ``pcmi_tpu.config``, and
    importing them (the packages' exports included) neither builds nor
    loads the kernel library."""
    _run_fresh("".join(f"import {m}\n" for m in MODULES) + _NO_REFERENCE
               + "from pcmi_tpu_torch.ops.stereo import _build\n"
               "assert _build._LIB is None\n"
               "assert not _build.BUILD_DIR.exists() or not any(\n"
               "    p.name.endswith('.tmp') for p in _build.BUILD_DIR.iterdir())\n")


def _chip_smoke_imports() -> list[str]:
    """Every module ``chip_smoke.py`` imports, at the top or inside its
    phases."""
    tree = ast.parse((PKG.parent / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return sorted(mods)


def test_chip_smoke_imports_leave_jax_out():
    mods = _chip_smoke_imports()
    assert "pcmi_tpu_torch.pipelines.height_map" in mods
    code = ("import sys\nsys.argv = ['chip_smoke.py']\nimport chip_smoke\n"
            + "".join(f"import {m}\n" for m in mods))
    _run_fresh(code + _NO_REFERENCE)


def test_no_file_imports_jax():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")), \
                f"{path}: {s}"


def test_nvcc_command_names_sm90a_and_every_source():
    srcs = sorted(p.name for p in (PKG / "csrc").glob("*.cu"))
    assert srcs == ["derive_right.cu", "derive_right_wdh.cu", "sgm_blocked.cu",
                    "sgm_dir.cu", "sgm_hwd.cu", "wta.cu"]
    compiles, link = _build.nvcc_commands(_build.library_path(), "nvcc")
    for cmd in compiles:  # one nvcc per source, each for sm_90a
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-fmad=false" in cmd and "--use_fast_math" not in cmd
        assert "-c" in cmd
    assert sorted(Path(c).name for cmd in compiles for c in cmd
                  if c.endswith(".cu")) == srcs
    objs = [cmd[cmd.index("-o") + 1] for cmd in compiles]
    assert "-shared" in link and sorted(objs) == sorted(
        c for c in link if c.endswith(".o"))
    lib = _build.library_path()
    assert lib.parent == PKG.parent / "build" / "pcmi_tpu_torch"
    assert lib.name.startswith("libpcmi_kernels_") and lib.suffix == ".so"


def test_library_name_hashes_sources_and_headers(tmp_path, monkeypatch):
    """An edited source or shared header gives another library name, so a
    stale build is never loaded."""
    import shutil

    assert [h.name for h in _build.headers()] == ["sgm_tile.cuh"]
    for src in ("sgm_dir.cu", "sgm_blocked.cu", "sgm_hwd.cu"):
        assert '#include "sgm_tile.cuh"' in (PKG / "csrc" / src).read_text()
    shutil.copytree(PKG / "csrc", tmp_path / "csrc")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path / "csrc")
    assert _build.library_path().parent == _build.BUILD_DIR
    names = {_build.library_path().name}
    for edited in ("sgm_tile.cuh", "wta.cu"):
        with open(tmp_path / "csrc" / edited, "a") as fh:
            fh.write("// edited\n")
        names.add(_build.library_path().name)
    assert len(names) == 3


def test_cpu_tensors_leave_launch_counters_at_zero():
    K.reset_launches()
    vol = torch.rand(6, 5, 7, generator=torch.Generator().manual_seed(0))
    h = K.sgm_pair(vol, 0.03, 0.48, horizontal=True)
    v = K.sgm_pair(vol, 0.03, 0.48, horizontal=False)
    K.wta(h, v, 0.25, -3, 1, True, True)
    K.wta(h, v, 0.25, -3, 1, True, True, with_aggregate=True)
    K.wta(vol, None, 1.0, -3, 1, False, False)
    K.derive_right(vol, -3, 1.0, 1)
    hwd = vol.permute(1, 2, 0).contiguous()
    K.sgm_hwd(hwd, 0.03, 0.48, 0, False, out=K.sgm_hwd(hwd, 0.03, 0.48, 1, True))
    blocked = torch.rand(1, 5, 8, 128, generator=torch.Generator().manual_seed(1))
    K.sgm_blocked(blocked, 0.03, 0.48, True, prev=blocked)
    K.derive_right_wdh(hwd, 3, 4, -2, 1, 1.0)
    assert K.LAUNCHES == {"sgm_dir": 0, "wta": 0, "derive_right": 0,
                          "sgm_hwd": 0, "sgm_blocked": 0,
                          "derive_right_wdh": 0}


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


@pytest.mark.parametrize("span", [53, 896, 1152])
@pytest.mark.parametrize("horizontal", [True, False])
def test_sgm_dir_plan_fits_every_disparity_count(span, horizontal):
    """K1's launch plan fits one block's shared memory for every D the
    kernel takes, and passes the checks of ``pcmi_sgm_dir`` (csrc)."""
    for D in range(1, K.SGM_DIR_MAX_DISP + 1):
        for acc in (False, True):
            p = K.sgm_dir_plan(D, span, horizontal, acc)
            assert p.smem == K.sgm_dir_smem(D, p.paths, p.tile, acc) \
                <= K.SMEM_BLOCK_MAX
            assert _pow2(p.paths) and 4 <= p.paths <= 16
            assert _pow2(p.tile) and p.tile <= 32
            assert p.paths * p.tile <= max(256, 32 * p.paths)
    for D in (0, K.SGM_DIR_MAX_DISP + 1):
        with pytest.raises(ValueError):
            K.sgm_dir_plan(D, span, horizontal, False)


@pytest.mark.parametrize("nb", [1, 7, 9])
@pytest.mark.parametrize("with_prev", [False, True])
def test_sgm_blocked_plan_fits_every_disparity_count(nb, with_prev):
    """K5's launch plan fits one block's shared memory and thread limit
    for every Dp the kernel takes, and passes the checks of
    ``launch_tiles`` (csrc/sgm_tile.cuh) and ``pcmi_sgm_blocked``."""
    for Dp in range(1, K.SGM_BLOCKED_MAX_DISP + 1):
        p = K.sgm_blocked_plan(Dp, nb, with_prev)
        assert p.smem == K.sgm_dir_smem(Dp, p.paths, p.tile, with_prev) \
            <= K.SMEM_BLOCK_MAX
        threads = max(256, 32 * p.paths)
        assert p.paths in (8, 16) and threads <= 512
        assert K.BAND % p.paths == 0
        assert _pow2(p.tile) and p.tile <= 32
        assert p.paths * p.tile <= threads
    for Dp in (0, K.SGM_BLOCKED_MAX_DISP + 1):
        with pytest.raises(ValueError):
            K.sgm_blocked_plan(Dp, nb, with_prev)
    # the shapes of the card's parity phase: the measured best
    assert K.sgm_blocked_plan(80, 7, with_prev)[:2] == (8, 8)
    assert K.sgm_blocked_plan(144, 9, with_prev)[:2] == (16, 4 if with_prev
                                                         else 8)


@pytest.mark.parametrize("span", [53, 896, 1152])
@pytest.mark.parametrize("horizontal", [True, False])
def test_sgm_dir_plan_bf16_fits_every_disparity_count(span, horizontal):
    """K1's launch plan for 2-byte elements fits one block's shared memory
    for every D (planes padded by 16 bytes: 8 elements), passes the checks
    of ``launch_typed`` (csrc/sgm_tile.cuh), and never takes fewer paths
    or, with as many, a shorter tile than the float32 plan."""
    src = (PKG / "csrc" / "sgm_tile.cuh").read_text()
    assert "(paths * tile + 16 / esize)" in src
    assert "g.Sp = g.P * g.T + 16 / esize;" in src
    for D in range(1, K.SGM_DIR_MAX_DISP + 1):
        for acc in (False, True):
            p = K.sgm_dir_plan(D, span, horizontal, acc, esize=2)
            assert p.smem == K.sgm_dir_smem(D, p.paths, p.tile, acc, 2) \
                == 2 * D * (p.paths * p.tile + 8) * (2 if acc else 1) * 2 \
                <= K.SMEM_BLOCK_MAX
            assert _pow2(p.paths) and 4 <= p.paths <= 16
            assert _pow2(p.tile) and p.tile <= 32
            assert p.paths * p.tile <= max(256, 32 * p.paths)
            p4 = K.sgm_dir_plan(D, span, horizontal, acc)
            # past 726 planes float32 may fall back to blocks of 8
            # columns where bfloat16 still fits 16
            assert p.paths == p4.paths or (D > 512 and p.paths > p4.paths)
            assert p.paths > p4.paths or p.tile >= p4.tile
            assert K.sgm_dir_plan(D, span, horizontal, acc, esize=4) == p4
    # a deep volume takes a longer tile in half the bytes
    assert K.sgm_dir_plan(144, 1152, True, True).tile == 16
    assert K.sgm_dir_plan(144, 1152, True, True, esize=2).tile == 32


@pytest.mark.parametrize("nb", [1, 7, 9])
@pytest.mark.parametrize("with_prev", [False, True])
def test_sgm_blocked_plan_bf16_fits_every_disparity_count(nb, with_prev):
    """K5's launch plan for 2-byte elements: as the float32 test."""
    for Dp in range(1, K.SGM_BLOCKED_MAX_DISP + 1):
        p = K.sgm_blocked_plan(Dp, nb, with_prev, esize=2)
        assert p.smem == K.sgm_dir_smem(Dp, p.paths, p.tile, with_prev, 2) \
            <= K.SMEM_BLOCK_MAX
        threads = max(256, 32 * p.paths)
        assert p.paths in (8, 16) and threads <= 512
        assert K.BAND % p.paths == 0
        assert _pow2(p.tile) and p.tile <= 32
        assert p.paths * p.tile <= threads
        assert p.tile >= K.sgm_blocked_plan(Dp, nb, with_prev).tile
    assert K.sgm_blocked_plan(144, 9, with_prev, esize=2)[:2] == (16, 8)


@pytest.mark.parametrize("accumulate", [False, True])
def test_sgm_hwd_plan_fits_every_disparity_count(accumulate):
    """K4's launch plan fits one block's shared memory and thread limit
    for every D the kernel takes and passes the checks of
    ``pcmi_sgm_hwd`` (csrc), whose block is ``SGM_HWD_WARPS`` warps."""
    src = (PKG / "csrc" / "sgm_hwd.cu").read_text()
    assert f"constexpr int kWarps = {K.SGM_HWD_WARPS};" in src
    assert 32 * K.SGM_HWD_WARPS <= 1024
    for D in range(1, K.SGM_HWD_MAX_DISP + 1):
        p = K.sgm_hwd_plan(D, accumulate)
        assert p.smem == K.sgm_hwd_smem(D, p.tile, accumulate) \
            <= K.SMEM_BLOCK_MAX
        assert 1 <= p.tile <= 16
        assert p.tile == 1 or p.smem <= K.SGM_HWD_WARPS * 10 * 1024
    for D in (0, K.SGM_HWD_MAX_DISP + 1):
        with pytest.raises(ValueError):
            K.sgm_hwd_plan(D, accumulate)
    # the shapes of the card's parity phase: the measured best
    assert K.sgm_hwd_plan(80, accumulate).tile == (8 if accumulate else 16)
    assert K.sgm_hwd_plan(144, accumulate).tile == (4 if accumulate else 8)


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA card raises, and mixed devices raise."""
    meta = torch.empty(4, 3, 5, device="meta")
    with pytest.raises(ValueError):
        K.sgm_dir(meta, 0.03, 0.48, True, False)
    with pytest.raises(ValueError):
        K.wta(meta, None, 1.0, -2)
    with pytest.raises(ValueError):
        K.derive_right(meta, -2)
    with pytest.raises(ValueError):
        K.sgm_hwd(meta, 0.03, 0.48, 0, False)
    with pytest.raises(ValueError):
        K.sgm_blocked(torch.empty(1, 4, 8, 128, device="meta"), 0.03, 0.48,
                      False)
    with pytest.raises(ValueError):
        K.derive_right_wdh(meta, 2, 2, 0)
    with pytest.raises(ValueError):
        K.wta(torch.zeros(4, 3, 5), meta, 1.0, -2)


def test_sgm_kernels_take_1024_planes():
    """The SGM kernels' largest D (``kMaxPer`` disparities per lane in
    ``csrc/sgm_tile.cuh``) is the wrappers', and past 512 planes the plans
    still fit: K1's vertical accumulating scan at D = 1024 on a wide
    volume falls back from blocks of 16 columns to 8 (196,608 bytes), and
    K4 takes tiles of one step past its ring rule."""
    src = (PKG / "csrc" / "sgm_tile.cuh").read_text()
    assert "constexpr int kMaxPer = 32;" in src
    assert K.SGM_DIR_MAX_DISP == K.SGM_HWD_MAX_DISP == \
        K.SGM_BLOCKED_MAX_DISP == 1024
    assert K.sgm_dir_plan(1024, 1152, False, True) == (8, 1, 196_608)
    assert K.sgm_dir_plan(1024, 1152, False, False) == (16, 1, 163_840)
    assert K.sgm_dir_plan(512, 1152, False, True).paths == 16
    assert K.sgm_hwd_plan(1024, True) == (1, 32_768)
    assert K.sgm_hwd_plan(512, True).tile == 1
    assert K.sgm_blocked_plan(1024, 8, True) == (8, 1, 196_608)
