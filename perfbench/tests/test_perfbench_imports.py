"""What a run may load: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``pcmi_tpu`` (compared whole: ``pcmi_tpu_torch``
is the program), and nothing of the program from the reference."""

import json
import subprocess
import sys
import textwrap

from perfbench import harness

from .conftest import REPO


def _python(code: str, cwd) -> dict:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=cwd, capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_names_are_compared_whole(monkeypatch):
    for name in ("pcmi_tpu_torch", "pcmi_tpu_torch.ops", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert "pcmi_tpu" not in harness.forbidden_modules()
    assert "jax" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pcmi_tpu.config", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert {"pcmi_tpu", "jaxlib"} <= set(harness.forbidden_modules())


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    from .conftest import tiny_root

    root = tiny_root(tmp_path)
    got = _python("""
        import json, sys
        from perfbench import harness
        r = harness.run_cell('.', 'd288_pair.strict', 3, 0.2, False,
                             device='cpu', log=lambda s: None)
        tops = sorted({m.split('.')[0] for m in sys.modules})
        print(json.dumps({"correct": r["correct"], "tops": tops,
                          "forbidden": harness.forbidden_modules()}))
    """, root)
    assert got["correct"] is True
    assert got["forbidden"] == []
    assert "pcmi_tpu_torch" in got["tops"]


def test_the_reference_imports_nothing_of_the_program():
    mods = sorted(
        "perfbench.reference." + str(p.relative_to(
            REPO / "perfbench" / "reference").with_suffix("")
        ).replace("/", ".")
        for p in (REPO / "perfbench" / "reference").rglob("*.py")
        if p.name != "__init__.py")
    got = _python(f"""
        import importlib, json, sys
        for m in {mods!r}:
            importlib.import_module(m)
        print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
    """, REPO)
    assert len(mods) >= 15
    assert not {"pcmi_tpu_torch", "pcmi_tpu", "jax", "jaxlib", "flax"} & set(got)
