"""The port's package boundary and kernel plumbing (no card needed)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pcmi_tpu_torch.ops.pointcloud import knn_select
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
    # the host side: plugin contract, registry, command line, viewer host,
    # I/O, ingest and sweep
    "pcmi_tpu_torch.interface", "pcmi_tpu_torch.registry",
    "pcmi_tpu_torch.cli", "pcmi_tpu_torch.viewer", "pcmi_tpu_torch.io",
    "pcmi_tpu_torch.io.kml", "pcmi_tpu_torch.io.raster",
    "pcmi_tpu_torch.io.native", "pcmi_tpu_torch.io.jp2k",
    "pcmi_tpu_torch.io.nitf", "pcmi_tpu_torch.io.crop",
    "pcmi_tpu_torch.io.sentinel", "pcmi_tpu_torch.pipelines.ingest",
    "pcmi_tpu_torch.pipelines.sweep",
    # the component pipelines and the U-Net serving path
    "pcmi_tpu_torch.pipelines.saliency", "pcmi_tpu_torch.pipelines.detection",
    "pcmi_tpu_torch.pipelines.restoration",
    "pcmi_tpu_torch.pipelines.stitching", "pcmi_tpu_torch.pipelines.landuse",
    "pcmi_tpu_torch.models", "pcmi_tpu_torch.models.unet",
    "pcmi_tpu_torch.models.metrics", "pcmi_tpu_torch.pipelines.superres",
    # the reference's CPU multiply-adds
    "pcmi_tpu_torch.ops.fused",
    # generative restoration, the GAN and DIP trainers, the detector
    "pcmi_tpu_torch.models.losses", "pcmi_tpu_torch.models.dip",
    "pcmi_tpu_torch.models.training", "pcmi_tpu_torch.models.detector",
    "pcmi_tpu_torch.models.detector_eval", "pcmi_tpu_torch.models.scenes",
    "pcmi_tpu_torch.pipelines.generative",
    # tiled diffusion and the scale-out layer
    "pcmi_tpu_torch.models.diffusion", "pcmi_tpu_torch.parallel",
    "pcmi_tpu_torch.parallel.mesh", "pcmi_tpu_torch.parallel.halo",
    "pcmi_tpu_torch.parallel.fusion_sharded",
    "pcmi_tpu_torch.parallel.multihost",
]


def test_pipelines_exports():
    import pcmi_tpu.pipelines as ref
    import pcmi_tpu_torch.pipelines as port

    for name in ("HeightMapPipeline", "MultiDayFusion",
                 "StreamingAOIPipeline", "HeightMapExtractor", "AOISpec",
                 "MultiAOISweep", "SaliencyDetector", "RestorationEngine",
                 "RestorationPlugin", "ImageStitcher", "ImageStitchingPlugin",
                 "OBIAClassifier", "LandUseClassificationPlugin",
                 "ObjectDetector", "ObjectAnnotationPlugin",
                 "InpaintingPlugin", "SuperResolutionPlugin",
                 "RestorationGenerativePlugin", "ImageRestorationProcessor",
                 "StitchingProcessor", "EnhancementProcessor",
                 "available_engines"):
        assert hasattr(ref, name) and hasattr(port, name), name
    # every name the port exports is one the reference exports
    assert set(port.__all__) <= set(ref.__all__) | {"fused_consistency_dsm"}


def test_models_exports():
    """The port's ``models`` exports the reference's names, each from its
    own module, and ``models.diffusion`` the reference module's public
    names."""
    import pcmi_tpu.models as ref
    import pcmi_tpu.models.diffusion as ref_diffusion
    import pcmi_tpu_torch.models as port
    import pcmi_tpu_torch.models.diffusion as port_diffusion

    assert port.__all__ == ref.__all__
    for name in port.__all__:
        mod = getattr(ref, name).__module__.replace("pcmi_tpu.",
                                                    "pcmi_tpu_torch.")
        assert getattr(port, name).__module__ == mod, name
    for name in ("MAX_PROMPT_TOKENS", "TOKEN_HASH_BUCKETS",
                 "tokenize_prompt", "TextEncoder", "CondUNet",
                 "DiffusionConfig", "Schedule", "make_schedule",
                 "karras_sigmas", "sobel_edges", "gaussian_weights",
                 "tile_origins", "TiledDiffusionEngine"):
        assert hasattr(ref_diffusion, name) and hasattr(port_diffusion,
                                                         name), name


def test_parallel_exports():
    """``pcmi_tpu_torch.parallel`` exports the reference's fourteen names,
    each from the module of the same path."""
    import pcmi_tpu.parallel as ref
    import pcmi_tpu_torch.parallel as port

    assert port.__all__ == ref.__all__ and len(port.__all__) == 14
    for name in port.__all__:
        obj = getattr(port, name)
        if callable(obj):
            assert obj.__module__ == getattr(ref, name).__module__.replace(
                "pcmi_tpu.", "pcmi_tpu_torch."), name
        else:
            assert obj == getattr(ref, name), name


def test_package_and_io_exports():
    """The plugin contract from the package and the I/O names from
    ``io``, as the reference exports them."""
    import pcmi_tpu
    import pcmi_tpu.io
    import pcmi_tpu_torch
    import pcmi_tpu_torch.io

    assert pcmi_tpu_torch.__all__ == pcmi_tpu.__all__
    assert pcmi_tpu_torch.io.__all__ == pcmi_tpu.io.__all__
    for name in pcmi_tpu_torch.io.__all__:
        assert getattr(pcmi_tpu_torch.io, name).__module__.startswith(
            "pcmi_tpu_torch.io."), name


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
    loads the kernel library, nor the native I/O library. The build
    directory also holds the I/O library, which other test processes may
    be building meanwhile: the temporary files looked for are the kernel
    library's."""
    _run_fresh("".join(f"import {m}\n" for m in MODULES) + _NO_REFERENCE
               + "from pcmi_tpu_torch.ops.stereo import _build\n"
               "assert _build._LIB is None\n"
               "assert not _build.BUILD_DIR.exists() or not any(\n"
               "    p.name.startswith('libpcmi_kernels_')\n"
               "    and p.name.endswith('.tmp') for p in _build.BUILD_DIR.iterdir())\n"
               "from pcmi_tpu_torch.io import native\n"
               "assert native._lib is None and native._lib_error is None\n")


def test_python_m_leaves_jax_out():
    """``python -m pcmi_tpu_torch --help`` and ``list`` run without JAX,
    the reference package or either library."""
    _run_fresh("import runpy, sys\n"
               "for argv in (['--help'], ['list']):\n"
               "    sys.argv = ['pcmi_tpu_torch', *argv]\n"
               "    try:\n"
               "        runpy.run_module('pcmi_tpu_torch', run_name='__main__')\n"
               "    except SystemExit as exc:\n"
               "        assert exc.code == 0, exc.code\n"
               + _NO_REFERENCE
               + "from pcmi_tpu_torch.ops.stereo import _build\n"
               "from pcmi_tpu_torch.io import native\n"
               "assert _build._LIB is None and native._lib is None\n")


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
    assert srcs == ["cost_volume.cu", "derive_right.cu", "derive_right_wdh.cu",
                    "knn_select.cu", "sgm_blocked.cu", "sgm_dir.cu",
                    "sgm_hwd.cu", "wta.cu"]
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
    img = vol[0]
    cen = K.census(img, 3)
    K.cost_volume(img, cen, img > 0.1, img.flip(1).contiguous(), cen,
                  img > 0.2, d_min=-2, planes=4, stride=1, block=3,
                  census_window=3, ad_weight=0.3)
    knn_select(vol[0, :4, :3].contiguous(), torch.ones(4, dtype=torch.bool),
               2)
    assert K.LAUNCHES == {"sgm_dir": 0, "wta": 0, "derive_right": 0,
                          "sgm_hwd": 0, "sgm_blocked": 0,
                          "derive_right_wdh": 0, "cost_volume": 0,
                          "census": 0, "knn_select": 0}


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
            deep = p.paths < 4  # the deep form: no second-input tile
            assert p.smem == K.sgm_dir_smem(D, p.paths, p.tile,
                                            acc and not deep) \
                <= K.SMEM_BLOCK_MAX
            assert _pow2(p.paths) and (1 if horizontal else 4) <= p.paths \
                <= 16
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
            ring = acc and p.paths >= 4  # the deep form: no second input
            assert p.smem == K.sgm_dir_smem(D, p.paths, p.tile, ring, 2) \
                == 2 * D * (p.paths * p.tile + 8) * (2 if ring else 1) * 2 \
                <= K.SMEM_BLOCK_MAX
            assert _pow2(p.paths) and (1 if horizontal else 4) <= p.paths \
                <= 16
            assert _pow2(p.tile) and p.tile <= 32
            assert p.paths * p.tile <= max(256, 32 * p.paths)
            p4 = K.sgm_dir_plan(D, span, horizontal, acc)
            if p4.paths >= 4:
                # past 726 planes float32 may fall back to blocks of 8
                # columns where bfloat16 still fits 16
                assert p.paths == p4.paths or (D > 512
                                               and p.paths > p4.paths)
                assert p.paths > p4.paths or p.tile >= p4.tile
            else:
                # both take the deep form at one depth, bfloat16 with a
                # tile as long or longer
                assert p.paths < 4 and p.tile >= p4.tile
            assert K.sgm_dir_plan(D, span, horizontal, acc, esize=4) == p4
    # a deep volume takes a longer tile in half the bytes
    assert K.sgm_dir_plan(144, 1152, True, True).tile == 16
    assert K.sgm_dir_plan(144, 1152, True, True, esize=2).tile == 32


# K1's plans before the deep form, as runs (last D, paths, tile) from D = 1:
# horizontal ("h"), vertical on 1,024 columns or more ("v16") or fewer
# ("v8"), by element size and accumulate
PARENT_K1_PLANS = {
    ("h", 4, False): [(220, 4, 32), (427, 4, 16), (807, 4, 8), (1024, 4, 4)],
    ("h", 4, True): [(110, 4, 32), (213, 4, 16), (403, 4, 8), (726, 4, 4),
                     (1024, 4, 2)],
    ("h", 2, False): [(427, 4, 32), (807, 4, 16), (1024, 4, 8)],
    ("h", 2, True): [(213, 4, 32), (403, 4, 16), (726, 4, 8), (1024, 4, 4)],
    ("v16", 4, False): [(220, 16, 8), (427, 16, 4), (807, 16, 2),
                        (1024, 16, 1)],
    ("v16", 4, True): [(110, 16, 8), (213, 16, 4), (403, 16, 2),
                       (726, 16, 1), (1024, 8, 1)],
    ("v16", 2, False): [(427, 16, 8), (807, 16, 4), (1024, 16, 2)],
    ("v16", 2, True): [(213, 16, 8), (403, 16, 4), (726, 16, 2),
                       (1024, 16, 1)],
    ("v8", 4, False): [(427, 8, 8), (807, 8, 4), (1024, 8, 2)],
    ("v8", 4, True): [(213, 8, 8), (403, 8, 4), (726, 8, 2), (1024, 8, 1)],
    ("v8", 2, False): [(807, 8, 8), (1024, 8, 4)],
    ("v8", 2, True): [(403, 8, 8), (726, 8, 4), (1024, 8, 2)],
}


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("accumulate", [False, True])
def test_sgm_dir_deep_plan_exactly_where_runs_fall_under_a_sector(
        esize, accumulate):
    """K1 takes the deep horizontal form exactly where a 4-row tile's runs
    (tile x element size) fall under one 32-byte sector: from 808 planes
    (404 accumulating) in float32 and in bfloat16. There
    its runs are 64 bytes, in blocks of two rows where they fit; everywhere
    else the plan is the one K1 took before the deep form."""
    first = 404 if accumulate else 808
    for key, span in (("h", 53), ("h", 1536), ("v8", 896), ("v16", 1152)):
        runs = PARENT_K1_PLANS[key, esize, accumulate]
        for D in range(1, K.SGM_DIR_MAX_DISP + 1):
            parent = next((p, t) for last, p, t in runs if D <= last)
            p = K.sgm_dir_plan(D, span, key == "h", accumulate, esize)
            deep = key == "h" and parent[1] * esize < K.SECTOR_BYTES
            assert deep == (key == "h" and D >= first)
            assert (p.paths < 4) == deep
            if deep:
                assert p.tile * esize >= 64
                # two rows of 64-byte runs where they fit, else one
                assert (p.paths, p.tile) == (
                    (2, 16) if esize == 4 and D <= 807 else (1, 64 // esize))
                assert p.smem == K.sgm_dir_smem(D, p.paths, p.tile, False,
                                                esize)
            else:
                assert p == (*parent, K.sgm_dir_smem(D, *parent, accumulate,
                                                     esize))


def test_sgm_dir_deep_form_matches_the_source():
    """The deep form as ``csrc/sgm_tile.cuh`` launches it: horizontal
    blocks of 1 or 2 paths, shared memory ``tile_smem_bytes`` with no
    second-input tile (``sgm_dir_smem(..., False)``), a kernel built for
    the disparities per lane of every D a deep plan takes, and a copying
    thread's 16-byte items of a tile within the registers it holds them
    in (``kDeepItems``) in every one-row block whose rows are 16-byte
    aligned (two-row blocks past 480 planes read them at the store)."""
    src = (PKG / "csrc" / "sgm_tile.cuh").read_text()
    assert "const bool deep = g.horizontal && g.P < 4;" in src
    assert "tile_smem_bytes(g.D, g.P, g.T, acc && !deep, esize)" in src
    assert "constexpr bool kDeepBuilt = kBuilt<kPer> && kPer >= 13;" in src
    assert "constexpr int kDeepThreads = 256;" in src
    assert "constexpr int kDeepItems = 20;" in src
    for esize in (4, 2):
        for D in range(1, K.SGM_DIR_MAX_DISP + 1):
            for acc in (False, True):
                p = K.sgm_dir_plan(D, 1536, True, acc, esize)
                if p.paths >= 4:
                    continue
                per = -(-D // 32)
                assert (per if per <= 16 else 32) >= 13
                assert p.smem == 2 * D * (p.paths * p.tile + 16 // esize) \
                    * esize <= K.SMEM_BLOCK_MAX
                items_per_plane = p.paths * p.tile * esize // 16
                dstep = (256 - 32 * p.paths) // items_per_plane
                assert (256 - 32 * p.paths) % items_per_plane == 0
                assert -(-D // dstep) <= 20 or (p.paths == 2 and D > 480)


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


@pytest.mark.parametrize("block", [1, 3, 9, 15])
@pytest.mark.parametrize("stride", [1, 2, 4])
def test_cost_volume_plan_fits_and_covers(block, stride):
    """K7's launch plan fits one block's shared memory and its grid covers
    the volume, for census 3/5/7, D from 16 to 1024 planes of the search
    and the cells' canvases; the box form's constants are the source's."""
    src = (PKG / "csrc" / "cost_volume.cu").read_text()
    th, tw = K.CV_BOX_TILE
    assert (f"constexpr int kBoxTH = {th}, kBoxTW = {tw}, kRV = 8, kRH = 8, "
            f"kNB = {K._CV_BOX_PLANES};") in src
    assert f"constexpr int kTablePad = {K._CV_TABLE_PAD};" in src
    assert f"constexpr int kSmemMax = {K.SMEM_BLOCK_MAX};" in src
    for case in "1, 3, 5, 7, 9, 11, 13, 15".split(", "):
        assert f"case {case}: return launch_box<{case}>" in src
    assert K.CV_BOX_SIZES == (1, 3, 5, 7, 9, 11, 13, 15)
    for census_window in (3, 5, 7):
        for max_disp in range(16, 1025, 16):
            D = max_disp // stride
            for H, W in ((37, 141), (896, 896), (1152, 1280), (1280, 1280)):
                p = K.cost_volume_plan(D, H, W, block)
                assert p.box == (block in K.CV_BOX_SIZES)
                assert p.smem == K.cost_volume_smem(block, p.tile_h,
                                                    p.tile_w, p.box) \
                    <= K.SMEM_BLOCK_MAX
                gx, gy, gz = p.grid
                assert gx * p.tile_w >= W > (gx - 1) * p.tile_w
                assert gy * p.tile_h >= H > (gy - 1) * p.tile_h
                assert gz * p.group >= D > (gz - 1) * p.group
                assert gy <= 65535 and gz <= 65535
            K._check_census_window(census_window)


def test_cost_volume_generic_plan():
    """Block sizes outside the box form take the generic form: haloed rows
    of whole warps, two blocks to an SM where that fits, and a refusal
    before anything runs where even one row does not fit."""
    for block in (2, 4, 16, 17, 31, 33, 64):
        p = K.cost_volume_plan(288, 1280, 1280, block)
        assert not p.box
        assert (p.tile_w + block - 1) % 32 == 0 and p.tile_w >= 64
        assert p.smem <= K.SMEM_BLOCK_MAX
        if block <= 17:
            assert p.tile_h == 32 and p.smem <= K._CV_TWO_BLOCKS
    with pytest.raises(ValueError):
        K.cost_volume_plan(288, 1280, 1280, 101)
    for bad in ((0, 8, 8, 3), (8, 0, 8, 3), (8, 8, 8, 0)):
        with pytest.raises(ValueError):
            K.cost_volume_plan(*bad)


@pytest.mark.parametrize("k", [0, 1, 3, 7, 8, 12, 15, 16, 31])
def test_knn_select_plan_covers_and_fits(k):
    """K8's plan over sizes from k + 1 to 2,621,440 points: its list holds
    k + 1 keys and is one the source instantiates, as is its count of
    queries a thread, the query tiles cover every query and the grid
    fits; the constants are the source's."""
    src = (PKG / "csrc" / "knn_select.cu").read_text()
    assert f"constexpr int kThreads = {K._KNN_THREADS};" in src
    assert f"constexpr int kMaxK1 = {K.KNN_MAX_K1};" in src
    for n in sorted({k + 1, k + 2, 255, 257, 1000, 4096, 65537, 327680,
                     655360, 2621440} - set(range(k + 1))):
        p = K.knn_select_plan(n, n, k)
        assert p.cap >= k + 1 and f"case {p.cap}: return (int)launch_cap<" \
            f"{p.cap}>" in src
        assert p.cap < 2 * (k + 1) or p.cap == 2
        assert f"case {p.queries}:" in src
        per_tile = K._KNN_THREADS * p.queries
        assert p.tiles * per_tile >= n > (p.tiles - 1) * per_tile
        assert 1 <= p.tiles < 2 ** 31


def test_knn_select_plan_refuses():
    """No plan for k + 1 past the longest list or past the points; the
    wrapper takes card tensors of the packed shapes only, and refuses
    before loading the library."""
    for bad in ((100, 100, 32), (100, 100, -1), (8, 8, 8), (0, 8, 1)):
        with pytest.raises(ValueError):
            K.knn_select_plan(*bad)
    q, n, c = torch.zeros(8, 3), torch.zeros(8), torch.zeros(8, 4)
    for bad in ((q, n, c), (q[:, :2], n, c), (q, n[:4], c), (q, n, c[:, :3])):
        with pytest.raises(ValueError):
            K.knn_select(*bad, 2)
    assert K.LAUNCHES["knn_select"] == 0


def _global_kernels(path: Path) -> list:
    """The names of the ``__global__`` functions defined in a CUDA source."""
    import re

    text = path.read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                      r"(\w+)\s*\(", text)


def test_kernel_names_outside_the_stereo_roofline():
    """The roofline of K1-K3 (``stereo_kernels_roofline``) counts every
    device operation whose name holds a fragment under
    ``perfbench/kernels/stereo_kernels/``: no other kernel of the package
    may carry one, or its time would join the roofline's without its work."""
    frags = [p.read_text().strip() for p in sorted(
        (PKG.parent / "perfbench" / "kernels" / "stereo_kernels").glob("*.txt"))]
    assert frags
    names = {src.name: _global_kernels(src)
             for src in sorted((PKG / "csrc").glob("*.cu"))}
    assert names["cost_volume.cu"] == ["census_kernel", "cost_volume_kernel",
                                       "cost_volume_box_kernel"]
    for src, kernels in names.items():
        if src in ("sgm_dir.cu", "wta.cu", "derive_right.cu"):   # K1-K3
            continue
        for kernel in kernels:
            assert not any(f in kernel for f in frags), (src, kernel)


def test_entry_points_declared_as_the_sources_define_them():
    """Every ``extern "C"`` entry point of ``csrc/*.cu`` has its argument
    kinds in ``kernels.SIGNATURES``, and nothing else there: as many, a
    pointer for each pointer, a float for each float and an int for each
    int (ctypes would pass an undeclared pointer as a 32-bit int)."""
    import re

    defined = {}
    for src in sorted((PKG / "csrc").glob("*.cu")):
        for name, args in re.findall(r'extern "C" int pcmi_(\w+)\(([^)]*)\)',
                                     src.read_text()):
            kinds = []
            for arg in (a.strip() for a in args.split(",") if a.strip()):
                kinds.append("p" if "*" in arg else
                             "f" if arg.startswith("float") else "i")
            defined[name] = "".join(kinds)
    assert {"census", "cost_volume", "sgm_dir", "wta", "knn_select",
            "sgm_dir_max_disp"} <= set(defined)
    assert defined == K.SIGNATURES
    # each launch takes the stream last; the library module names none
    assert all(k.endswith("p") for n, k in K.SIGNATURES.items()
               if n in K.LAUNCHES)
    text = Path(_build.__file__).read_text()
    assert not any(f"pcmi_{name}" in text for name in defined)


class _FakeLib:
    """A stand-in for the loaded library: each entry point records its
    arguments and returns ``rc``."""

    def __init__(self, rc: int = 0):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.rc
        return entry


@pytest.fixture
def fake_lib(monkeypatch):
    """``kernels`` launching into a :class:`_FakeLib` on stream 77."""
    lib = _FakeLib()
    monkeypatch.setattr(K, "library", lambda: lib)
    monkeypatch.setattr(K, "_stream", lambda: 77)
    K.reset_launches()
    yield lib
    K.reset_launches()


def test_launch_passes_the_stream_last(fake_lib):
    K._launch("census", 1, 2, 3, 8, 9, 5)
    assert fake_lib.calls == [("pcmi_census", (1, 2, 3, 8, 9, 5, 77))]


def test_refused_launch_raises_and_counts_nothing(fake_lib):
    fake_lib.rc = 700
    with pytest.raises(_build.KernelError, match="^wta: .* 700"):
        K._launch("wta", 0)
    assert not any(K.LAUNCHES.values())


def test_launch_counts_once(fake_lib):
    K._launch("knn_select", 0)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), "knn_select": 1}


def test_k1_wrapper_launches_with_its_plan(fake_lib, monkeypatch):
    """K1's wrapper, past its device check: the forward and accumulating
    launches of one axis with their plans' paths and tiles, each plan
    counted in the open span."""
    from pcmi_tpu_torch.utils import profiling

    monkeypatch.setattr(K, "_on_cuda", lambda *a, **k: True)
    cost = torch.zeros(288, 8, 96)
    with profiling.recording(), profiling.span("view") as rec:
        out = K.sgm_pair(cost, 0.03, 0.48, horizontal=False)
    fwd, acc = (K.sgm_dir_plan(288, 96, False, a) for a in (False, True))
    assert [args[-4:-1] for _, args in fake_lib.calls] == [
        (fwd.paths, fwd.tile, 0), (acc.paths, acc.tile, 0)]
    assert fake_lib.calls[1][1][1] == out.data_ptr()
    assert rec.counts == {
        "launches": {"sgm_dir": 2},
        "plans": {f"v {fwd.paths}x{fwd.tile} fwd": 1,
                  f"v {acc.paths}x{acc.tile} acc": 1}}


@pytest.mark.parametrize("dtype,tile", [(torch.float32, 16),
                                        (torch.bfloat16, 32)])
def test_k1_wrapper_launches_the_deep_plan(fake_lib, monkeypatch, dtype,
                                           tile):
    """At 992 planes K1's wrapper passes the deep horizontal plan (one row
    a block) to both launches of the axis and records its plan strings in
    the open span."""
    from pcmi_tpu_torch.utils import profiling

    monkeypatch.setattr(K, "_on_cuda", lambda *a, **k: True)
    cost = torch.zeros(992, 2, 64, dtype=dtype)
    with profiling.recording(), profiling.span("view") as rec:
        K.sgm_pair(cost, 0.03, 0.48, horizontal=True)
    bf16 = int(dtype == torch.bfloat16)
    assert [args[-4:-1] for _, args in fake_lib.calls] == [
        (1, tile, bf16), (1, tile, bf16)]
    assert [args[5:8] for _, args in fake_lib.calls] == [(1, 0, 0),
                                                         (1, 1, 1)]
    assert rec.counts == {
        "launches": {"sgm_dir": 2},
        "plans": {f"h 1x{tile} fwd": 1, f"h 1x{tile} acc": 1}}


def test_cost_volume_wrappers_refuse_before_running():
    """K7 and the census wrapper: a tensor on neither the CPU nor a card,
    mixed devices, a census window outside [3, 7] or mismatched planes
    raise before anything runs; on the CPU they are the plain versions."""
    img = torch.rand(6, 9, generator=torch.Generator().manual_seed(2))
    cen = K.census(img, 5)
    kw = dict(d_min=-8, planes=16, stride=1, block=3, census_window=5,
              ad_weight=0.3)
    K.reset_launches()
    with pytest.raises(ValueError):
        K.census(img.to("meta"), 5)
    with pytest.raises(ValueError):
        K.census(img, 9)
    with pytest.raises(ValueError):
        K.census(img[None], 5)
    with pytest.raises(ValueError):
        K.cost_volume(img.to("meta"), cen, img > 0, img, cen, img > 0, **kw)
    with pytest.raises(ValueError):
        K.cost_volume(img, cen, img > 0, img[:5], cen, img > 0, **kw)
    with pytest.raises(ValueError):
        K.cost_volume(img, cen, img > 0, img, cen, img > 0,
                      **{**kw, "census_window": 4})
    for got, ref in zip(cen, K.census_plain(img, 5)):
        assert torch.equal(got, ref)
    vol = K.cost_volume(img, cen, img > 0.2, img.flip(1).contiguous(), cen,
                        img > 0.1, **kw)
    ref = K.cost_volume_plain(img, cen, img > 0.2, img.flip(1).contiguous(),
                              cen, img > 0.1, -8, 16, 1, 3, 5, 0.3,
                              torch.float32)
    assert torch.equal(vol, ref) and vol.shape == (16, 6, 9)
    assert not any(K.LAUNCHES.values())
