"""The benchmark's CPU tests (``python -m pytest portbench/tests`` from the
repository's root): the harness at tiny sizes on the CPU, with the
port's plain paths.  The control at the cells' own sizes runs on the card
through ``portbench/readings.py``."""

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the tiny sizes every cell runs at here (the configurations' own are the
# card's): FW-away converges in a few hundred iterations at 10x100
TINY = {"m": 10, "n": 100, "fw_maxitrs": 5000, "abpg_gain_maxitrs": 300}
# ABPG-gain's head followed row by row, so that a tail lies past it
TINY_HEAD = 32
# the limits of the numbers that depend on the size and the budget (the
# limits files hold the card's): at 10x100 ABPG-gain's slack reads
# 1.2-1.6e-3 after 300 iterations and 0.04 after 32, and one step moves F
# by 2e-5 of |F| (the plain reference on the CPU, seeds 11 and 12)
TINY_LIMITS = {"fresh_sp": 1e-2, "last_F_gap": 1e-3}


def tiny_tree(dst: Path) -> Path:
    """A copy of the benchmark (``BENCHMARK.json`` and ``portbench/``) in
    ``dst`` with every configuration at ``TINY``, every mix's batch and
    pool cut to fit, and the limits of ``TINY_LIMITS`` at the tiny size's;
    returns the copied ``BENCHMARK.json``."""
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for path in (dst / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update({k: v for k, v in TINY.items() if k in cfg})
        path.write_text(json.dumps(cfg))
    for path in (dst / "portbench" / "mixes").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["batch"] = min(int(mix.get("batch", 1)), 4)
        mix["pool"] = 2 * mix["batch"]
        if mix["entry"] == "abpg_gain":
            mix["check"]["rows"] = TINY_HEAD
        path.write_text(json.dumps(mix))
    for path in (dst / "portbench" / "limits").glob("*.json"):
        lim = json.loads(path.read_text())
        lim.update({k: v for k, v in TINY_LIMITS.items() if k in lim})
        path.write_text(json.dumps(lim))
    return dst / "BENCHMARK.json"


def cells():
    return [w["name"] for w in
            json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
