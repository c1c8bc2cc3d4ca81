"""What the benchmark loads: no module of JAX or of the JAX package in a
run (by whole top-level names: the port's begins with the JAX package's),
nothing of the port in the plain reference, and no result without a card
or without the port."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT, tiny_tree
from portbench.core import runner

CELL = "dopt_random_1000x5000.fw_away"


def _python(code, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_forbidden_names_are_whole_top_level_names():
    assert runner.forbidden_modules(
        ["accbpg_and_fw_tpu_torch", "accbpg_and_fw_tpu_torch.ops",
         "jaxtyping", "flaxen.x", "numpy"]) == []
    assert runner.forbidden_modules(
        ["jax.numpy", "jaxlib", "flax.linen", "accbpg_and_fw_tpu.ops",
         "accbpg"]) == ["accbpg", "accbpg_and_fw_tpu", "flax", "jax",
                        "jaxlib"]


def test_a_run_loads_nothing_of_jax(tmp_path):
    spec = tiny_tree(tmp_path)
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from portbench.core import runner
spec = json.loads(Path({str(spec)!r}).read_text())
for w in spec["workloads"]:
    runner.run(w["name"], 7, 0.0, device="cpu", require_chips=False,
               spec_path=Path({str(spec)!r}),
               base=Path({str(tmp_path / 'portbench')!r}))
print(json.dumps(runner.forbidden_modules()))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_the_reference_loads_nothing_of_the_port():
    code = """
import json, sys
sys.path.insert(0, '.')
from portbench.core.registry import load_module
for name in ("dopt_fw", "dopt_abpg_gain"):
    load_module("reference", name)
import portbench.core.judging, portbench.core.window
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.splitlines()[-1]))
    assert not tops & {"accbpg_and_fw_tpu_torch", "accbpg_and_fw_tpu",
                       "accbpg", "jax", "jaxlib", "flax"}


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "2147483659", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "cuda" in out.stderr.lower()


def test_no_port_no_result(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout == ""
