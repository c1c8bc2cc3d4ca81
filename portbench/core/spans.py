"""The program's spans as the per-layer readers take them.

The port records spans in memory while its switch
``diagnostics.SPANS`` is on: ``(id, parent_id, solve_id, name, t0_ns,
t1_ns, attrs)`` on the host's ``time.perf_counter_ns()``, appended as each
closes.  The harness calls a reader's ``snapshot(port)`` before and after
the window of a traced run.  The first snapshot of the window turns the
recorder on, where it is off; the first after it turns it off again, so
the traced slice after the window runs as it does without these readers.
A snapshot returns the count of spans closed so far; the change between a
reader's two is the window's count, and the window's spans are that many
up to the end of the list.  So the readers cover the whole window, with
the profiler off.  Against a port without the recorder a snapshot returns
nothing, and the reader finds nothing to read (None).

A reader's snapshots go by its quantity: the first of a quantity is
before the window, the second after it.  A quantity is split by cells
(``<quantity>.<part>``), so a cell reads one part of each.
"""

from __future__ import annotations

# the list the snapshots read, its length at the latest snapshot, whether
# the snapshots turned the recorder on, and the quantities snapshotted
# before and after the window of the run under way
_STATE = {"out": None, "end": 0, "ours": False, "before": set(),
          "after": set()}


def _recorder(port):
    return getattr(getattr(port, "diagnostics", None), "SPANS", None)


def snapshot(port, quantity: str) -> dict:
    """``{"spans": spans closed so far}`` at the reader ``quantity``'s
    snapshot; ``{}`` for a port without the recorder."""
    rec = _recorder(port)
    if rec is None:
        return {}
    st = _STATE
    if quantity not in st["before"]:
        st["before"].add(quantity)
        if rec[0] is None:
            rec[0] = []
            st["ours"] = True
        st["out"] = rec[0]
    else:
        if st["ours"] and rec[0] is st["out"]:
            rec[0] = None
        st["ours"] = False
        st["after"].add(quantity)
    st["end"] = len(st["out"])
    got = {"spans": st["end"]}
    if st["after"] == st["before"]:
        # every reader has taken both: the next snapshot is another run's
        st["before"], st["after"] = set(), set()
    return got


def window(ctx, quantity: str):
    """The spans closed in the window, as the snapshots of the metric
    ``quantity`` (or of its part ``<quantity>.<part>``) counted them; None
    where they counted none."""
    for name, got in ctx.counters.items():
        if (name == quantity or name.startswith(quantity + ".")) \
                and "spans" in got:
            end = _STATE["end"]
            return _STATE["out"][end - got["spans"]:end]
    return None


def seconds(spans, name: str) -> float:
    """The seconds of the spans named ``name``."""
    return 1e-9 * sum(s[5] - s[4] for s in spans if s[3] == name)
