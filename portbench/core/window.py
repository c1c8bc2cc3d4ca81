"""The measured window of a closed loop, and the arithmetic of the
end-to-end metrics over it.

One caller issues solver calls back to back, each on the next instances
of the pool, until ``seconds`` have passed; the call under way then runs
to its end, and the window closes when it returns.  Each call is timed on
the host clock from its start to its returned result (the entry ends it
in a synchronise).  Every metric here is taken over all calls and all the
time of the window.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, NamedTuple

import numpy as np


class Answer(NamedTuple):
    """What one call returned, as the judge and the metrics read it.

    ``x``: (K, n) final iterates (a tensor on the call's device); ``hist``:
    history name -> (K, T) numpy array; ``rows``: (K,) rows each instance
    emitted up to and including its stop row (its iterations);
    ``instances``: the pool indices solved."""
    x: object
    hist: dict
    rows: np.ndarray
    instances: tuple

    @property
    def iterations(self) -> int:
        return int(np.sum(self.rows))


class Call(NamedTuple):
    start: float   # seconds after the window opened
    wall: float    # seconds from the call's start to its result
    answer: Answer


class Window(NamedTuple):
    calls: List[Call]
    seconds: float  # from the first call's start to the last one's end

    @property
    def instances(self) -> int:
        return sum(len(c.answer.instances) for c in self.calls)

    @property
    def iterations(self) -> int:
        return sum(c.answer.iterations for c in self.calls)


def run_window(call: Callable, instances_of: Callable, seconds: float,
               sync: Callable = lambda: None,
               clock: Callable = time.perf_counter) -> Window:
    """Calls ``call(instances_of(j))`` for j = 0, 1, ... until ``seconds``
    have passed since the first began (at least one call)."""
    calls = []
    t0 = clock()
    j = 0
    while True:
        idx = instances_of(j)
        t = clock()
        ans = call(idx)
        sync()
        t1 = clock()
        calls.append(Call(t - t0, t1 - t, ans))
        j += 1
        if t1 - t0 >= seconds:
            return Window(calls, t1 - t0)


def percentile(values, q: float) -> float:
    """The nearest-rank ``q`` percentile (0 < q < 100): a value that was
    read, of which at least q% are at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return float(vals[rank - 1])


def solve_seconds(window: Window) -> float:
    """The whole window over the instances solved in it."""
    return window.seconds / window.instances


def iteration_ms(window: Window) -> float:
    """The whole window over every iteration completed in it, in ms."""
    return 1e3 * window.seconds / window.iterations


def call_p90_seconds(window: Window) -> float:
    """The 90th percentile of every call's wall in the window."""
    return percentile([c.wall for c in window.calls], 90.0)
