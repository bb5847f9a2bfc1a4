"""A later change adds a configuration, a traffic mix, a per-layer metric and a cell as
new files (and entries in ``BENCHMARK.json``) without editing any file the benchmark has:
the harness finds each by its name."""
import json
import shutil
import subprocess
import sys
import textwrap

from conftest import BENCH_DIR, ROOT


def test_new_files_alone_make_a_new_cell(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "benchmark"

    config = json.loads((BENCH_DIR / "configs" / "camn.json").read_text())
    config.update(name="camn_narrow")
    config["model"].update(hidden_size=32, n_layer=2)
    (bench / "configs" / "camn_narrow.json").write_text(json.dumps(config))
    (bench / "traffic" / "offline-b3-1s-fp32.json").write_text(json.dumps(
        {"kind": "closed_loop", "batch": 3, "clip_seconds": 1.0, "warmup_calls": 1,
         "judge_one_of_first": 1, "trace_calls": 1,
         "limits": {"motion_err": 1e-5}}))
    (bench / "metrics" / "calls_traced.offline.py").write_text(textwrap.dedent('''
        def read(ctx):
            return float(ctx["result"]["calls"])
        '''))
    spec["configs"].append({"name": "camn_narrow", "source": "https://example.org/narrow",
                            "file": "benchmark/configs/camn_narrow.json", "reduced": [],
                            "why": "a narrow CaMN for this test"})
    spec["workloads"].append({"name": "camn_narrow-offline", "config": "camn_narrow",
                              "traffic": "offline-b3-1s-fp32", "chips": 1, "why": "test"})
    rate = next(m for m in spec["end_to_end"] if m["name"] == "motion_s_per_s")
    rate["workloads"].append("camn_narrow-offline")
    spec["per_layer"].append({"name": "calls_traced.offline", "unit": "calls",
                              "better": "higher", "source": "host_clock", "layer": "device",
                              "moves": "motion_s_per_s", "workloads": ["camn_narrow-offline"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    code = f"""
import json, sys, time
sys.path[:0] = [{str(bench)!r}, {str(tmp_path)!r}, {str(ROOT)!r}]
import run
from harness import common
cell = common.find_cell(common.load_spec(), 'camn_narrow-offline')
plain = run.run_cell(cell, 3, 0.0, False, time.time(), device='cpu')
traced = run.run_cell(cell, 3, 0.0, True, time.time(), device='cpu')
print(json.dumps([plain['line'], traced['line']]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = json.loads(out.stdout.strip().splitlines()[-1])
    assert plain["correct"] and set(plain["metrics"]) == {"motion_s_per_s", "setup_s"}
    assert traced["metrics"]["calls_traced.offline"]["value"] >= 1
    assert traced["correct"]
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "benchmark").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts and ".cache" not in p.parts}
    assert all(after[k] == v for k, v in before.items())  # nothing edited, only added
