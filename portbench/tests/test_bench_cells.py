"""Each cell driven through the harness at a tiny size on the CPU: sound
runs come out correct; the control (the reference in float32 in the
program's place) and the faults planted under the timed path come out
not correct (a state left unchanged, an answer altered, half a sweep
left out, a graph solve frozen past the head that the judge follows row
by row); a cell added as data files alone is found and runs."""

import json

import numpy as np
import pytest
import torch

from conftest import TINY_HEAD, cells, tiny_tree
from portbench.core import registry, runner
from portbench.core.window import Answer

SEED = 2**31 + 12345


def _run(spec, cell, hooks=None, seconds=0.0):
    base = spec.parent / "portbench"
    return runner.run(cell, SEED, seconds, device="cpu", require_chips=False,
                      spec_path=spec, base=base, hooks=hooks)[0]


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", cells())
def test_sound_run_is_correct(spec, cell):
    result = _run(spec, cell, seconds=0.2)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert list(result)[-1] == "checks"
    names = {m["name"] for m in registry.find_cell(
        cell, spec, spec.parent / "portbench").end_to_end}
    assert set(result["metrics"]) == names


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(spec, cell):
    base = spec.parent / "portbench"
    ref = registry.load_module(
        "reference", registry.find_cell(cell, spec, base).mix["reference"],
        base)
    assert not _run(spec, cell, hooks=ref.Control)["correct"]


class _Fault:
    """The entry's caller with its answers broken where they are made."""

    def __init__(self, caller, cell, pool, device, kind):
        self.inner, self.pool, self.kind = caller, pool, kind

    def _frozen(self, a, ks):
        x = a.x.clone()
        hist = {n: v.copy() for n, v in a.hist.items()}
        for k in ks:
            x[k] = self.pool.x0
            for v in hist.values():
                v[k, :] = v[k, 0]
        return Answer(x, hist, a.rows, a.instances)

    def _frozen_tail(self, a, idx):
        """The state frozen after the head that the judge follows row by
        row: the head's iterate returned, its F and gain in every later
        row, the rows as many as the budget's."""
        h = self.inner.call(idx, maxitrs=TINY_HEAD)
        hist = {n: v.copy() for n, v in a.hist.items()}
        hist["F"][:, TINY_HEAD:] = a.hist["F"][:, TINY_HEAD:TINY_HEAD + 1]
        hist["Gain"][:, TINY_HEAD:] = h.hist["Gain"][:, -1:]
        return Answer(h.x, hist, a.rows, a.instances)

    def call(self, idx, **kw):
        a = self.inner.call(idx, **kw)
        K = len(idx)
        if self.kind == "unchanged":      # a step that leaves its state
            return self._frozen(a, range(K))
        if self.kind == "frozen_tail":    # a chunk frozen past the head
            return self._frozen_tail(a, idx)
        if self.kind == "half_batch":     # half the batch left out
            return self._frozen(a, range(K // 2, K))
        x = a.x.clone()                   # an answer altered
        x[0, int(torch.argmax(x[0]))] *= 1.0 + 1e-3
        return Answer(x, a.hist, a.rows, a.instances)

    def close(self):
        self.inner.close()


def _faults():
    out = []
    for cell in cells():
        out += [(cell, "unchanged"), (cell, "altered")]
        if "sweep" in cell:
            out.append((cell, "half_batch"))
        if "abpg_gain" in cell:
            out.append((cell, "frozen_tail"))
    return out


@pytest.mark.parametrize("cell,kind", _faults())
def test_fault_is_not_correct(spec, cell, kind):
    def hooks(caller, c, pool, device):
        return _Fault(caller, c, pool, device, kind)

    result = _run(spec, cell, hooks=hooks)
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1
    if kind == "frozen_tail":
        # the head the judge follows is sound: the returned iterate fails
        checks = result["checks"]
        assert checks["follow_gap"]["value"] <= checks["follow_gap"]["limit"]
        assert checks["fresh_sp"]["value"] > checks["fresh_sp"]["limit"]
    json.dumps(result, allow_nan=False)  # the result line is strict JSON


def test_cell_added_as_data_files(tmp_path):
    """A configuration, a cell and its limits added as files and entries
    only: the harness finds them by name and runs the cell."""
    spec = tiny_tree(tmp_path)
    base = tmp_path / "portbench"
    (base / "configs" / "dopt_random_12x90.json").write_text(json.dumps({
        "name": "dopt_random_12x90", "problem": "dopt_random", "m": 12,
        "n": 90, "eps": 1e-8, "fw_maxitrs": 5000, "reduced": []}))
    (base / "mixes" / "fw_away_sweep2.json").write_text(json.dumps({
        "entry": "dopt_fw_batch", "reference": "dopt_fw", "batch": 2,
        "pool": 4, "trace": {"calls": 1},
        "check": {"sample": 2, "rows": 64}}))
    (base / "limits" / "dopt_random_12x90.fw_away_sweep2.json").write_text(
        (base / "limits" / "dopt_random_1000x5000.fw_away.json").read_text())
    bench = json.loads(spec.read_text())
    bench["configs"].append({
        "name": "dopt_random_12x90", "source": "made up for a test",
        "file": "portbench/configs/dopt_random_12x90.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "dopt_random_12x90.fw_away_sweep2",
        "config": "dopt_random_12x90", "traffic": "fw_away_sweep2",
        "chips": 1, "why": "a test"})
    bench["end_to_end"][1]["workloads"].append(
        "dopt_random_12x90.fw_away_sweep2")
    spec.write_text(json.dumps(bench))
    result = _run(spec, "dopt_random_12x90.fw_away_sweep2", seconds=0.1)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"setup_s", "solve_s"}
    assert result["attempted"] % 2 == 0


def test_stop_rows_of_a_sweep():
    from portbench.core.registry import load_module

    batch = load_module("entries", "dopt_fw_batch")
    SP = np.array([[1.0, 1e-9, 1e-9], [1.0, 1.0, 1.0]])
    SN = np.array([[1.0, 1e-9, 1e-9], [1.0, 1.0, 1.0]])
    assert batch.stop_rows(SP, SN, 1e-8).tolist() == [2, 3]


def test_every_metric_has_a_reader():
    """Each metric of the benchmark file is read by a file of its own or,
    split by cells as ``<quantity>.<part>``, by its quantity's."""
    bench = json.loads((registry.SPEC).read_text())
    for m in bench["end_to_end"]:
        if m["name"] != "setup_s":
            assert callable(registry.load_module("end_to_end",
                                                 m["name"]).read)
    for m in bench["per_layer"]:
        assert callable(registry.load_module("metrics", m["name"]).read)


def test_a_part_with_a_file_of_its_own_takes_it(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "q.py").write_text("WHO = 'quantity'\n")
    (tmp_path / "metrics" / "q.own.py").write_text("WHO = 'own'\n")
    assert registry.load_module("metrics", "q.cell", tmp_path).WHO == \
        "quantity"
    assert registry.load_module("metrics", "q.own", tmp_path).WHO == "own"
    with pytest.raises(FileNotFoundError):
        registry.load_module("metrics", "r.cell", tmp_path)
