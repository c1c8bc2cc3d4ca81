"""Debugging and profiling utilities (counterpart of
``accbpg_and_fw_tpu/diagnostics.py``).

* ``debug_mode()``: NaN (and optionally Inf) detection for the drivers;
* ``check_domain(h, x)``: eager validation of an iterate against a kernel's
  domain (the reference's assert semantics, usable at chunk boundaries);
* ``profile_trace(logdir)``: a ``torch.profiler`` trace of the enclosed
  solver run, written as a Chrome trace into ``logdir``, the program's
  spans in it;
* ``span(name, **attrs)`` and ``recording()``: the program's spans, host
  intervals recorded in memory while the switch ``SPANS`` is on;
* ``iteration_rate(T)``: iterations/second summary from a driver's T array;
* ``divergence_is_valid(h, x, y)``: D_h(x, y) finite and nonnegative.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import numpy as np
import torch

from . import _scalar
from ._device import full


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = False):
    """Raise ``FloatingPointError`` on a NaN (and, with ``infs``, an Inf)
    inside the enclosed solves.

    JAX's ``jax_debug_nans`` catches the fault at the faulting primitive.
    Eager PyTorch has no such hook short of a sync after every operation,
    so the check sits where the port reads values back anyway: every
    ``_scalar.read`` and every chunk boundary of ``run_driver`` (the
    chunk's histories).  A fault is caught at the first host read after the
    operation that produced it.  A NaN that no read sees does not raise:
    a rejected line-search trial's (the search counts it a failure), or a
    ``fast_gram`` gate's branch that the select did not take."""
    old = list(_scalar.DEBUG)
    _scalar.DEBUG[:] = [bool(nans), bool(infs)]
    try:
        yield
    finally:
        _scalar.DEBUG[:] = old


def check_domain(h, x):
    """Eagerly validate iterate ``x`` (a tensor, a sharded one too, or an
    array) against kernel ``h``'s domain, mirroring the reference's inline
    asserts (functions.py:243,252,260-261).

    Raises ValueError with a descriptive message on violation."""
    if isinstance(x, torch.Tensor):
        x = full(x).detach().cpu().numpy()
    x = np.asarray(x)
    name = type(h).__name__
    if not np.isfinite(x).all():
        raise ValueError(f"{name}: iterate contains NaN/Inf")
    if name.startswith("Burg") or name == "PowerNeg1":
        if x.min() <= 0:
            raise ValueError(f"{name} only takes positive arguments.")
    if name.startswith("Shannon"):
        if x.min() < 0:
            raise ValueError(f"{name} only takes nonnegative arguments.")
    if "Simplex" in name:
        s = float(x.sum())
        if abs(s - 1.0) > 1e-6 * max(1.0, abs(s)):
            raise ValueError(f"{name}: iterate off the simplex (sum={s!r})")
    return True


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the enclosed solver run with ``torch.profiler`` (CPU
    activity, and the card's where one is present) and write the trace
    into ``logdir`` as ``trace_<pid>_<ns>.json`` (Chrome/Perfetto format).
    The span recorder is on inside, so the program's spans are ranges of
    the trace.  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with recording(), torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# The span recorder's switch: None (off), or the list that every span
# closed while it is on is appended to, as ``(id, parent_id, solve_id,
# name, t0_ns, t1_ns, attrs)`` on ``time.perf_counter_ns()``.
SPANS = [None]
_OPEN = []                 # (id, solve_id) of the open spans, innermost last
_IDS = itertools.count(1)
# a profiler range by name: the fast form where torch has it (about a
# tenth of ``record_function``'s host cost)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


class _Off:
    """The one span every site gets while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """One recorded span: its parent is the enclosing open span, and the
    spans under one root (a solve) carry the root's id.  While a
    ``torch.profiler`` records, the span is also a ``record_function``
    range, stamped by the profiler on its own clock (a host record of a
    trace that takes the CPU activity; one with the CUDA activity alone
    keeps none)."""

    __slots__ = ("out", "name", "attrs", "id", "parent", "solve", "t0",
                 "mirror")

    def __init__(self, out, name, attrs):
        self.out, self.name, self.attrs = out, name, attrs

    def __enter__(self):
        self.id = next(_IDS)
        self.parent, self.solve = _OPEN[-1] if _OPEN else (None, self.id)
        _OPEN.append((self.id, self.solve))
        self.mirror = None
        if torch.autograd._profiler_enabled():
            self.mirror = _RANGE(self.name)
            self.mirror.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        _OPEN.pop()
        self.out.append((self.id, self.parent, self.solve, self.name,
                         self.t0, t1, self.attrs))
        return False


def span(name, **attrs):
    """A context manager that records the enclosed host interval as the
    span ``name`` while ``SPANS`` is on, and does nothing while it is off
    (one shared object).  Spans are host-side only: none sits in code that
    a graph captures, and none adds a device operation."""
    out = SPANS[0]
    if out is None:
        return _OFF
    return _Span(out, name, attrs)


@contextlib.contextmanager
def recording():
    """Turn the span recorder on for the block, where it is off, and yield
    the list of the spans closed while it is on (the list already being
    filled, where it was on)."""
    out = SPANS[0]
    if out is not None:
        yield out
        return
    out = SPANS[0] = []
    try:
        yield out
    finally:
        SPANS[0] = None


def iteration_rate(T):
    """(iters/s, total_s) summary of a driver wall-time array."""
    T = np.asarray(T)
    if len(T) < 2 or T[-1] <= 0:
        return float("nan"), float(T[-1] if len(T) else 0.0)
    return float((len(T) - 1) / T[-1]), float(T[-1])


def divergence_is_valid(h, x, y, atol=0.0):
    """D_h(x, y) >= -atol and finite, as a bool tensor (no host read)."""
    d = h.divergence(x, y)
    return torch.isfinite(d) & (d >= -atol)
