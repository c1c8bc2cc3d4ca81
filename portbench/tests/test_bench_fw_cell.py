"""The FW shortest-step cell at a tiny size on the CPU, beside the faults
that every cell gets (``test_bench_cells.py``): an iterate pushed out of
the ball, an F row altered inside the head that the reference runs free,
a run cut short past that head (its state frozen, its rows padded to the
budget's) and a stale iterate (the one at the last graph span's start,
with the rows of the whole run) each come out not correct, by the number
that reads them;
the new readers find nothing to read on a port without the live-trial
counter; the reference loads nothing of the port."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, tiny_tree
from portbench.core import registry, runner
from portbench.core.window import Answer

CELL = "fw_illcond_1000x1000.shortest_step"
SEED = 2**31 + 12345
ROW = 100   # an F row inside the free run's head
STALE = 32  # rows a stale iterate lags: a graph span's


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench_fw"))


def _cell(spec):
    return registry.find_cell(CELL, spec, spec.parent / "portbench")


class _Fault:
    """The entry's caller with its answers broken where they are made."""

    def __init__(self, caller, cell, pool, device, kind):
        self.inner, self.kind = caller, kind
        self.radius = float(cell.config["radius"])
        self.head = int(cell.mix["check"]["rows"])

    def call(self, idx, **kw):
        a = self.inner.call(idx, **kw)
        x, T = a.x.clone(), int(a.rows[0])
        hist = {n: v.copy() for n, v in a.hist.items()}
        if self.kind == "outside":
            x *= self.radius * (1.0 + 1e-6) / torch.linalg.vector_norm(x)
        elif self.kind == "F_row":
            hist["F"][0, ROW] *= 1.0 + 1e-6
        elif self.kind == "stale":
            x = self.inner.call(idx, maxitrs=T - STALE).x
        else:  # cut short past the head: its state frozen, rows padded
            assert T > self.head + 2
            cut = self.head + (T - self.head) // 2
            x = self.inner.call(idx, maxitrs=cut).x
            hist["F"][0, cut:] = a.hist["F"][0, cut]
            hist["Ls"][0, cut:] = a.hist["Ls"][0, cut - 1]
        return Answer(x, hist, a.rows, a.instances)

    def close(self):
        self.inner.close()


@pytest.mark.parametrize("kind,number", [("outside", "ball_excess"),
                                         ("F_row", "rows_gap"),
                                         ("cut_short", "rule_gap"),
                                         ("stale", "last_F_rise")])
def test_fault_is_not_correct(spec, kind, number):
    def hooks(caller, cell, pool, device):
        return _Fault(caller, cell, pool, device, kind)

    result = runner.run(CELL, SEED, 0.0, device="cpu", require_chips=False,
                        spec_path=spec, base=spec.parent / "portbench",
                        hooks=hooks)[0]
    checks = result["checks"]
    assert not result["correct"] and result["failed"] >= 1
    assert checks[number]["value"] > checks[number]["limit"]
    if kind == "cut_short":
        # the free run's head and the iterate's ties hold: the rule alone
        # sees the rows it does not give
        for name in ("ball_excess", "last_F_rise", "rows_gap"):
            assert checks[name]["value"] <= checks[name]["limit"], name
    if kind == "stale":
        # the rows are sound: the iterate alone is not theirs, on every
        # call by its F and on the sampled calls by the rule's own
        for name in ("rows_gap", "rule_gap"):
            assert checks[name]["value"] <= checks[name]["limit"], name
        assert checks["x_gap"]["value"] > checks["x_gap"]["limit"]
    json.dumps(result, allow_nan=False)


def test_sound_rows_follow_the_rule(spec):
    """A sound run reads every number at its floor on the CPU: the port's
    rows are the reference's bit for bit."""
    result = runner.run(CELL, SEED, 0.0, device="cpu", require_chips=False,
                        spec_path=spec, base=spec.parent / "portbench")[0]
    checks = result["checks"]
    assert result["correct"]
    assert checks["rows_gap"]["value"] == checks["rule_gap"]["value"] == 0.0
    assert checks["x_gap"]["value"] == 0.0
    assert checks["ball_excess"]["value"] < 0.0
    assert checks["last_F_rise"]["value"] <= 0.0


class _NoCounter:
    """A port whose ``_loops`` has no live-trial counter (a parent)."""

    class _loops:
        LIVE = [None]


@pytest.mark.parametrize("name", ["ls_live_share.fw",
                                  "fw_logreg_iter_roofline"])
def test_readers_find_nothing_without_the_counter(name):
    reader = registry.load_module("metrics", name)
    assert reader.snapshot(_NoCounter()) == {}


def test_live_share_reads_the_window():
    reader = registry.load_module("metrics", "ls_live_share.fw")

    class Ctx:
        counters = {"ls_live_share.fw": {"live": 26, "run": 416}}

    assert reader.read(Ctx()) == 100.0 * 26 / 416
    Ctx.counters = {"ls_live_share.fw": {}}
    assert reader.read(Ctx()) is None


def test_roofline_counts_x_once_and_the_live_trials():
    work = registry.load_module("roofline", "fw_logreg")
    peaks = registry.load_module("roofline", "peaks")
    nbytes, flops = work.iter_work(1000, 1000, 2.5)
    assert nbytes == 8 * (1000 * 1000 + 1000 + 2000)
    assert flops == 2 * 1000 * 1000 * 4.5
    # X in the L2 or not, the bytes bound it at these shapes
    assert peaks.least_seconds(nbytes, flops) == nbytes / peaks.PEAK_BYTES


def test_the_new_references_load_nothing_of_the_port():
    code = """
import json, sys
sys.path.insert(0, '.')
from portbench.core.registry import load_module
for name in ("fw_l0l1_shortest", "dopt_abpg_gain_fastgram"):
    load_module("reference", name)
import portbench.core.judging, portbench.core.window
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.splitlines()[-1]))
    assert not tops & {"accbpg_and_fw_tpu_torch", "accbpg_and_fw_tpu",
                       "accbpg", "jax", "jaxlib", "flax"}
