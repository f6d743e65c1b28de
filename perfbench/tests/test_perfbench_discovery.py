"""A cell and a per-layer metric added as files only: a copy of the
benchmark's folder gets a new traffic mix and a new metric reader, and
``BENCHMARK.json`` new entries naming them; the copy runs them with no file
of the folder edited."""

import hashlib
import json
import os
import subprocess
import sys
import textwrap

from .conftest import REPO, tiny_root


def _digests(folder):
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_and_metric_need_new_files_only(tmp_path):
    root = tiny_root(tmp_path, copy_perfbench=True)
    pb = root / "perfbench"
    before = _digests(pb)
    (pb / "traffic" / "pair_trio.json").write_text(json.dumps({
        "driver": "pair_stream",
        "why": "three pairs traced",
        "trace_requests": 3,
        "limits": {"valid_mismatch": 0.0, "disp_gap_px": 0.0,
                   "xyz_gap_m": 0.0}}))
    (pb / "metrics" / "host.traced_pairs.pair.py").write_text(textwrap.dedent(
        '''
        """Pairs in the traced stretch."""


        def read(run):
            return float(len(run.requests))
        '''))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "d288_pair.trio", "config": "d288_pair",
                               "traffic": "pair_trio", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "d288_pair.strict" in m.get("workloads", []):
            m["workloads"].append("d288_pair.trio")
    bench["per_layer"].append({
        "name": "host.traced_pairs.pair", "unit": "pairs", "better": "higher",
        "source": "program_counter", "layer": "host", "moves": "pairs_per_s",
        "workloads": ["d288_pair.trio"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent("""
        import json
        from perfbench import harness
        assert harness.PERFBENCH.parent.resolve() == __import__('pathlib').Path('.').resolve()
        out = [harness.run_cell('.', 'd288_pair.trio', 11, 0.3, t,
                                device='cpu', log=lambda s: None)
               for t in (False, True)]
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}",
               OMP_NUM_THREADS="2")
    done = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    plain, traced = json.loads(done.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"setup_s", "pairs_per_s", "pair_ms_p95"}
    assert traced["metrics"]["host.traced_pairs.pair"]["value"] == 3.0
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before
