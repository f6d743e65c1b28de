"""Fixtures of the benchmark's tests: a checkout root whose configurations
are cut to a few hundred pixels, so each cell runs on the CPU in seconds,
and the ``card`` marker's fixture (tests that need a CUDA card skip
elsewhere; decided when the test runs, never at import)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


def tiny_root(dest: Path, copy_perfbench: bool = False) -> Path:
    """``dest`` as a checkout root: ``BENCHMARK.json`` with every
    configuration cut to a 64 px crop of a 64 px ground at 0.5 m and heights
    0-6 m (a few tens of planes on canvases of ~100 px), matched with
    windows and margins to suit (block 9, census 5, margin 8, stride 2),
    and, with
    ``copy_perfbench``, a copy of the benchmark's folder beside it."""
    dest.mkdir(parents=True, exist_ok=True)
    if copy_perfbench:
        shutil.copytree(REPO / "perfbench", dest / "perfbench",
                        ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (dest / "tiny").mkdir(exist_ok=True)
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg["scene"].update(crop_px=64, ground_shape=[64, 64], gsd=0.5,
                            h_range=[0.0, 6.0])
        cfg["scene"]["terrain"] = {"terrain_fraction": 0.6,
                                   "building_size_px": [5, 10],
                                   "building_h_m": [1.0, 3.0],
                                   "n_buildings": 3}
        cfg["pipeline"]["rectify"]["height_range"] = [0.0, 6.0]
        cfg["pipeline"]["stereo"] = {"block_size": 9, "census_window": 5,
                                     "margin_undefined": 8, "disp_stride": 2}
        c["file"] = f"tiny/{c['name']}.json"
        (dest / c["file"]).write_text(json.dumps(cfg))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a CUDA card")
