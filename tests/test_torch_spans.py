"""The port's spans and counters (``diagnostics.span``, ``SPANS``,
``recording``; the block engines' ``dopt.*`` spans and
``dopt_lazy.FROZEN_BLOCKS``; the graph chunks' ``graph.*`` spans and
``_GraphChunk.nodes``).

On the CPU: the recorder off records nothing and hands out one shared
object; on, a lazy solve and a lazy sweep give the tree ``dopt.solve``
over ``dopt.setup``, one ``dopt.block`` per block enqueued, ``dopt.read``
and ``dopt.rows``, each child inside its parent's interval under one
solve id; the frozen blocks are the group's less those that recorded
rows; a graph chunk with forced overflows records its replays, reads and
continuations in order; ``profile_trace`` shows the spans.

The tests marked ``cuda`` read a trace of the card: a span is a host
record of a trace with the CPU activity and of none with the CUDA
activity alone; the benchmark's trace summary names a host-only idle gap
inside ``dopt.rows`` by it; a ``dopt.read`` holds the end of its copy;
``_GraphChunk.nodes`` is the driver API's count of the entry's graph.
"""

import json
import os
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch import diagnostics as diag
from accbpg_and_fw_tpu_torch.algorithms import driver
from accbpg_and_fw_tpu_torch.ops import dopt_lazy as dl

torch.set_num_threads(1)

EPS = 1e-8
# 12x160 from seed 3 stops by eps at row 1068 (block 5 of 256 rows)
STOP_ROWS = 1069


@pytest.fixture(scope="module")
def design():
    V = np.random.default_rng(3).standard_normal((12, 160))
    return V, np.full(160, 1.0 / 160)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tree(spans):
    """``{id: span}`` of the recorded tuples, after checking that each
    child lies inside its parent's interval and shares its solve id."""
    by_id = {s[0]: s for s in spans}
    assert len(by_id) == len(spans)
    for sid, parent, solve, name, t0, t1, attrs in spans:
        assert t0 <= t1, name
        if parent is None:
            assert solve == sid, name
            continue
        p = by_id[parent]
        assert p[2] == solve, name
        assert p[4] <= t0 and t1 <= p[5], (name, p[3])
    return by_id


def _children(by_id, parent):
    return sorted((s for s in by_id.values() if s[1] == parent),
                  key=lambda s: s[4])


def test_recorder_off_records_nothing(design):
    V, x0 = design
    assert diag.SPANS[0] is None
    assert diag.span("dopt.solve") is diag.span("graph.read", rows=True)
    with diag.recording() as before:
        pass
    port.D_opt_FW_away(V, x0, EPS, 300, verbose=False, u_mode="pallas_lazy",
                       device="cpu")
    assert before == [] and diag.SPANS[0] is None and not diag._OPEN


def test_recording_nests_and_survives_a_raise():
    with diag.recording() as out:
        with diag.recording() as inner:
            assert inner is out
        with pytest.raises(ValueError):
            with diag.span("dopt.solve", m=2):
                with diag.span("dopt.read"):
                    raise ValueError("inside")
        assert diag.SPANS[0] is out
    assert diag.SPANS[0] is None and not diag._OPEN
    read, solve = out
    assert (read[3], solve[3]) == ("dopt.read", "dopt.solve")
    assert read[1] == solve[0] and read[2] == solve[0] == solve[2]
    assert solve[1] is None and solve[6] == {"m": 2}


def test_lazy_solve_records_its_tree(design):
    V, x0 = design
    frozen = dl.FROZEN_BLOCKS
    with diag.recording() as out:
        res = port.D_opt_FW_away(V, x0, EPS, 1500, verbose=False,
                                 u_mode="pallas_lazy", device="cpu")
    assert len(res[1]) == STOP_ROWS
    by_id = _tree(out)
    (root,) = [s for s in out if s[1] is None]
    assert root[3] == "dopt.solve"
    assert root[6] == {"engine": "pallas_lazy", "m": 12, "n": 160, "K": 1}
    # the default group of a 1500-iteration budget: 6 blocks in one group
    names = [s[3] for s in _children(by_id, root[0])]
    assert names == (["dopt.setup"] * 2 + ["dopt.block"] * 6
                     + ["dopt.read", "dopt.rows"])
    # the set-up's reads: the Cholesky factorization's info, the logdet
    setup = _children(by_id, root[0])[1]
    assert [s[3] for s in _children(by_id, setup[0])] == ["dopt.read"] * 2
    assert {s[2] for s in out} == {root[0]}
    # the stop falls in block 5: block 6 was launched past it
    assert dl.FROZEN_BLOCKS - frozen == 1


def test_lazy_sweep_records_its_tree():
    Vs = np.random.default_rng(3).standard_normal((2, 8, 60))
    x0s = np.full((2, 60), 1.0 / 60)
    frozen = dl.FROZEN_BLOCKS
    with diag.recording() as out:
        _, F, _, _ = port.dopt_fw_batch(Vs, x0s, EPS, 600,
                                        precision="pallas_lazy",
                                        device="cpu")
    by_id = _tree(out)
    (root,) = [s for s in out if s[1] is None]
    assert root[3] == "dopt.solve"
    assert root[6] == {"engine": "pallas_lazy", "m": 8, "n": 60, "K": 2}
    kids = [s[3] for s in _children(by_id, root[0])]
    # a group of 3 blocks (600 iterations), read once, then the padding
    assert kids == (["dopt.setup"] + ["dopt.block"] * 3
                    + ["dopt.read", "dopt.rows", "dopt.rows"])
    # the later instance stops at row 530, in the third block: none frozen
    assert F.shape == (2, 530) and dl.FROZEN_BLOCKS == frozen
    # two factorizations' reads, then the logdets'
    setup = _children(by_id, root[0])[0]
    assert [s[3] for s in _children(by_id, setup[0])] == ["dopt.read"] * 3


@pytest.mark.parametrize("group", [2, 4])
def test_frozen_blocks_are_the_group_less_its_rows(design, group):
    """Blocks of 256 rows: the solve records rows in ceil(1069 / 256) = 5
    blocks; every other block enqueued (the groups' rest) is frozen."""
    V, x0 = design
    before = dl.FROZEN_BLOCKS
    with diag.recording() as out:
        res = dl.dopt_fw_lazy(V, x0, EPS, 3000, verbose=False, group=group,
                              device="cpu")
    blocks = sum(s[3] == "dopt.block" for s in out)
    assert blocks == group * -(-5 // group)
    assert dl.FROZEN_BLOCKS - before == blocks - -(-len(res[1]) // 256)


def _overflow_step(c, k):
    """A bounded loop that needs three bodies at k = 2 and k = 13, one in
    the graph (as ``test_replay_stops_at_an_overflowed_span``)."""
    from accbpg_and_fw_tpu_torch import _loops

    target = torch.where((torch.as_tensor(k) == 2)
                         | (torch.as_tensor(k) == 13), 3.0, 0.0)
    n = _loops.device_while(lambda s: s[0] < target,
                            lambda s: (s[0] + 1.0,),
                            (torch.zeros((), dtype=torch.float64),),
                            None, 1)[0]
    v = c["v"] + n
    return (dict(done=c["done"], v=v),
            dict(F=v, _stop=torch.zeros((), dtype=torch.bool)))


def test_graph_chunk_records_replays_reads_and_continuations(monkeypatch):
    """Chunks of 24 over spans of 8 (the CPU runs the captured body as
    it is): the overflow at 2 stops the first replay after its first
    span, the one at 13 the second after its second."""
    carry = dict(done=torch.tensor(False),
                 v=torch.zeros((), dtype=torch.float64))
    monkeypatch.setattr(driver, "chunk_mode",
                        lambda carry, problem=None, cfg=None: "graph")
    before = driver.GRAPH_STATS["continuations"]
    with diag.recording() as out:
        driver.run_driver(_overflow_step, carry, 24, chunk=24,
                          verbose=False, graph_span=8)
    by_id = _tree(out)
    (root,) = [s for s in out if s[1] is None]
    assert root[3] == "driver.solve"
    got = [s[3] + ("+rows" if s[6].get("rows") else "")
           for s in _children(by_id, root[0])]
    first = ["graph.replay", "graph.read", "graph.read+rows",
             "graph.continuation"]
    second = ["graph.replay", "graph.read", "graph.replay", "graph.read",
              "graph.read+rows", "graph.continuation"]
    last = ["graph.replay", "graph.read", "graph.replay", "graph.read+rows"]
    assert got == first + second + last
    assert got.count("graph.continuation") == (
        driver.GRAPH_STATS["continuations"] - before) == 2
    assert "graph.capture" not in got  # nothing is captured on the CPU


def test_graph_stats_keep_counts_only():
    assert set(driver.GRAPH_STATS) == {"captures", "replays",
                                       "continuations"}


def test_profile_trace_shows_the_spans(design, tmp_path):
    V, x0 = design
    logdir = str(tmp_path / "trace")
    with diag.profile_trace(logdir):
        assert diag.SPANS[0] is not None
        port.D_opt_FW_away(V, x0, EPS, 300, verbose=False,
                           u_mode="pallas_lazy", device="cpu")
    assert diag.SPANS[0] is None
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as fh:
        names = Counter(e.get("name", "") for e in
                        json.load(fh)["traceEvents"])
    assert names["dopt.solve"] == 1 and names["dopt.block"] == 2
    assert names["dopt.rows"] == 1 and names["dopt.read"] == 3


# ---- on the card ------------------------------------------------------------

def _card_trace(run, cpu=True):
    """``run()`` under ``torch.profiler`` with the recorder on, with the
    CPU and CUDA activities (``profile_trace``'s) or the CUDA activity
    alone (the benchmark's traced slice): ``(host records, device
    operations)``, each ``(name, start_us, end_us)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with diag.recording(), profile(activities=acts) as p:
        run()
        torch.cuda.synchronize()
    host, dev = [], []
    for e in p.events():
        row = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type != DeviceType.CUDA:
            host.append(row)
        elif not getattr(e, "is_user_annotation", False):
            dev.append(row)
    return host, dev


@pytest.mark.cuda
def test_span_is_a_host_record_where_the_trace_keeps_host_ranges(cuda_dev):
    """A trace with the CPU activity holds the span; one with the CUDA
    activity alone (the benchmark's slice) keeps no host range, the span's
    included, on torch 2.11."""
    def run():
        with diag.span("dopt.rows"):
            torch.ones(1000, device=cuda_dev).sum()

    host, _ = _card_trace(run)
    assert "dopt.rows" in [name for name, _, _ in host]
    host, _ = _card_trace(run, cpu=False)
    assert "dopt.rows" not in [name for name, _, _ in host]


@pytest.mark.cuda
def test_trace_summary_names_a_host_gap_by_its_span(cuda_dev):
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench.core.trace import summarize

    a = torch.randn(512, 512, device=cuda_dev, dtype=torch.float64)
    (a @ a).sum()  # cuBLAS's handle and workspace before the trace
    torch.cuda.synchronize()

    def run():
        (a @ a).sum()
        torch.cuda.synchronize()
        with diag.span("dopt.rows"):
            time.sleep(0.02)  # the host's own work: no CUDA call
        (a @ a).sum()

    host, dev = _card_trace(run)
    gaps = dict(summarize(dev, host).idle_gaps)
    assert max(gaps, key=gaps.get) == "dopt.rows"
    assert gaps["dopt.rows"] >= 0.015


@pytest.mark.cuda
def test_read_span_holds_its_copy(design, cuda_dev):
    V, x0 = design
    Vc = torch.as_tensor(V, device=cuda_dev)

    def run():
        dl.dopt_fw_lazy(Vc, x0, EPS, 1500, verbose=False, group=2)

    host, dev = _card_trace(run)
    reads = [(s, e) for name, s, e in host if name == "dopt.read"]
    copies = [e for name, _, e in dev if "DtoH" in name]
    # the Cholesky factorization's info and the logdet, then one copy a
    # group of two blocks (3 groups)
    assert len(reads) == 5
    for s, e in reads:
        assert any(s <= end <= e for end in copies), (s, e)


@pytest.mark.cuda
def test_graph_nodes_are_the_driver_apis_count(cuda_dev):
    import ctypes

    driver.clear_graph_cache()
    f, h, L, x0 = port.D_opt_design(10, 60, randseed=2, device="cuda")
    port.ABPG_gain(f, h, L, x0, gamma=2, maxitrs=64, verbose=False)
    entries = list(driver._GRAPHS.values())
    assert entries
    cu = ctypes.CDLL("libcuda.so.1")
    for e in entries:
        n = ctypes.c_size_t(0)
        assert cu.cuGraphGetNodes(ctypes.c_void_p(e.graph.raw_cuda_graph()),
                                  None, ctypes.byref(n)) == 0
        assert e.nodes == n.value > 0
    driver.clear_graph_cache()
