"""The readers of the program's spans and counters (``core/spans.py``,
``metrics/host_serial_ms.py`` and the rest) on made-up spans, against a
port without the recorder, and over real lazy solves on the CPU."""

from collections import OrderedDict
from types import SimpleNamespace

import numpy as np
import pytest

from portbench.core import registry, spans

NEW = ("host_serial_ms.dopt", "frozen_blocks_per_solve.dopt",
       "continuation_ms_per_kiter",
       "replay_launch_ms_per_kiter", "graph_nodes_per_iter.bregman")
MS = 1_000_000  # ns


def _span(sid, parent, solve, name, t0_ms, t1_ms, **attrs):
    return (sid, parent, solve, name, t0_ms * MS, t1_ms * MS, attrs)


def _port(recorder=True, frozen=None, graphs=None):
    diag = SimpleNamespace(SPANS=[None]) if recorder else SimpleNamespace()
    lazy = SimpleNamespace() if frozen is None else SimpleNamespace(
        FROZEN_BLOCKS=frozen)
    driver = SimpleNamespace(_GRAPHS=graphs or OrderedDict())
    return SimpleNamespace(diagnostics=diag, ops=SimpleNamespace(
        dopt_lazy=lazy), algorithms=SimpleNamespace(driver=driver))


def _ctx(port, names, window_spans, instances=1, iterations=1000,
         after=(), during=None):
    """The context the harness hands the readers: ``names``' snapshots
    before and after a window in which ``window_spans`` close (and
    ``during()`` runs), then ``after`` spans close (the traced slice)."""
    readers = {n: registry.load_module("metrics", n) for n in names}
    before = {n: r.snapshot(port) for n, r in readers.items()
              if hasattr(r, "snapshot")}
    rec = getattr(port.diagnostics, "SPANS", [None])
    if rec[0] is not None:
        rec[0].extend(window_spans)
    if during is not None:
        during()
    counters = {}
    for n, snap in before.items():
        now = readers[n].snapshot(port)
        counters[n] = {k: now[k] - v for k, v in snap.items()}
    if rec[0] is not None:
        rec[0].extend(after)
    ctx = SimpleNamespace(port=port, counters=counters, window=SimpleNamespace(
        instances=instances, iterations=iterations))
    return ctx, {n: r.read(ctx) for n, r in readers.items()}


# two solves: 100 ms and 50 ms.  The first's set-up (14 ms, a read of
# 10 ms inside) and rows (9 ms) are its serial work; its block and its
# group's read are not.  The second's read under the solve is no set-up's,
# and its refresh (10 ms) holds a read of 4 ms.  A span of another root is
# no solve's.
SOLVES = [
    _span(3, 2, 1, "dopt.read", 2, 12),
    _span(2, 1, 1, "dopt.setup", 1, 15),
    _span(4, 1, 1, "dopt.block", 15, 16),
    _span(5, 1, 1, "dopt.read", 60, 90),
    _span(6, 1, 1, "dopt.rows", 90, 99),
    _span(1, None, 1, "dopt.solve", 0, 100, engine="pallas_lazy"),
    _span(8, 7, 7, "dopt.read", 110, 130),
    _span(11, 10, 7, "dopt.read", 132, 136),
    _span(10, 7, 7, "dopt.refresh", 130, 140),
    _span(7, None, 7, "dopt.solve", 100, 150),
    _span(9, None, 9, "driver.solve", 150, 400),
    _span(13, 12, 12, "dopt.rows", 400, 420),
]


def test_serial_work_leaves_out_blocks_and_reads():
    _, got = _ctx(_port(), ["host_serial_ms.dopt"], SOLVES, instances=2)
    assert got["host_serial_ms.dopt"] == pytest.approx((4 + 9 + 6) / 2)
    assert spans.seconds(SOLVES, "dopt.read") == pytest.approx(0.064)


def test_block_loop_readers_over_the_window():
    slice_ = [_span(21, None, 21, "dopt.solve", 500, 900)]
    ctx, got = _ctx(_port(frozen=40), NEW[:2], SOLVES, instances=2,
                    after=slice_)
    assert got["host_serial_ms.dopt"] == pytest.approx(9.5)
    # the counter did not move: no block launched past a stop
    assert got["frozen_blocks_per_solve.dopt"] == 0.0
    assert ctx.counters["host_serial_ms.dopt"] == {"spans": len(SOLVES)}


def test_recorder_is_off_for_the_slice_and_the_next_run():
    """The window's first snapshot after it turns the recorder off again,
    so the traced slice runs with it off; a second run in one process
    takes its own window."""
    port = _port(graphs=OrderedDict())
    rec = port.diagnostics.SPANS
    names = ["continuation_ms_per_kiter", "replay_launch_ms_per_kiter"]
    graph = [_span(2, 1, 1, "graph.continuation", 0, 30),
             _span(1, None, 1, "driver.solve", 0, 40)]
    _, got = _ctx(port, names, graph, iterations=1000)
    assert rec[0] is None
    assert got["continuation_ms_per_kiter"] == pytest.approx(30.0)
    _, got = _ctx(port, names, graph[:1] * 2 + graph[1:], iterations=1000)
    assert rec[0] is None
    assert got["continuation_ms_per_kiter"] == pytest.approx(60.0)
    # a recorder already on (an operator's) stays on
    rec[0] = []
    try:
        _ctx(port, names, graph, iterations=1000)
        assert rec[0] == graph
    finally:
        rec[0] = None


def test_frozen_blocks_over_the_instances():
    port = _port(frozen=7)

    def window():
        port.ops.dopt_lazy.FROZEN_BLOCKS += 348

    _, got = _ctx(port, ["frozen_blocks_per_solve.dopt"], [], instances=2,
                  during=window)
    assert got["frozen_blocks_per_solve.dopt"] == pytest.approx(174.0)


def test_graph_readers_per_thousand_iterations():
    graph = [
        _span(2, 1, 1, "graph.replay", 0, 2),
        _span(3, 1, 1, "graph.read", 2, 40),
        _span(4, 1, 1, "graph.replay", 40, 43),
        _span(5, 1, 1, "graph.read", 43, 80, rows=True),
        _span(6, 1, 1, "graph.continuation", 80, 150),
        _span(1, None, 1, "driver.solve", 0, 200),
    ]
    entry = SimpleNamespace(nodes=40768, span=32)
    graphs = OrderedDict([("old", SimpleNamespace(nodes=5, span=1)),
                          ("used", entry)])
    _, got = _ctx(_port(graphs=graphs), NEW[2:], graph, iterations=2000)
    assert got["continuation_ms_per_kiter"] == pytest.approx(35.0)
    assert got["replay_launch_ms_per_kiter"] == pytest.approx(2.5)
    assert got["graph_nodes_per_iter.bregman"] == pytest.approx(1274.0)


def test_no_continuation_reads_zero():
    _, got = _ctx(_port(), ["continuation_ms_per_kiter"],
                  [_span(1, None, 1, "driver.solve", 0, 5)])
    assert got["continuation_ms_per_kiter"] == 0.0


def test_a_port_without_the_recorder_reads_nothing():
    """The parent of the recorder: every reader finds nothing and none
    raises."""
    graphs = OrderedDict([("g", SimpleNamespace(span=32))])
    ctx, got = _ctx(_port(recorder=False, graphs=graphs), NEW, [],
                    instances=3)
    assert all(v is None for v in got.values()), got
    assert all(c == {} for c in ctx.counters.values())
    _, got = _ctx(_port(recorder=False), ["graph_nodes_per_iter.bregman"],
                  [])
    assert got["graph_nodes_per_iter.bregman"] is None


def test_readers_over_real_lazy_solves():
    """Two lazy solves of a 12x160 design on the CPU (stop at row 1068, a
    group of 8 blocks of 256 rows for the budget of 2000): the serial work
    is the set-ups and rows less their reads, a part of each solve, the
    three blocks past the stop are counted, and the recorder is off
    after the window."""
    import accbpg_and_fw_tpu_torch as port

    V = np.random.default_rng(3).standard_normal((12, 160))
    x0 = np.full(160, 1.0 / 160)

    def window():
        for _ in range(2):
            port.D_opt_FW_away(V, x0, 1e-8, 2000, verbose=False,
                               u_mode="pallas_lazy", device="cpu")

    try:
        ctx, got = _ctx(port, NEW[:2], [], instances=2, during=window)
        assert port.diagnostics.SPANS[0] is None
        done = spans.window(ctx, "host_serial_ms")
    finally:
        port.diagnostics.SPANS[0] = None
    solves = [s for s in done if s[3] == "dopt.solve"]
    assert len(solves) == 2
    total_ms = 1e-6 * sum(s[5] - s[4] for s in solves) / 2
    serial = {s[0] for s in done if s[3] in ("dopt.setup", "dopt.rows")}
    ns = sum(s[5] - s[4] for s in done if s[0] in serial) - sum(
        s[5] - s[4] for s in done if s[3] == "dopt.read" and s[1] in serial)
    assert got["host_serial_ms.dopt"] == pytest.approx(1e-6 * ns / 2)
    assert 0 < got["host_serial_ms.dopt"] < total_ms
    assert got["frozen_blocks_per_solve.dopt"] == 3.0
