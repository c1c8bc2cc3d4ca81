"""Bounded data-dependent loops for the port's steps: ``device_while``.

JAX's steps write a line search or a Newton solve as a ``lax.while_loop``
that runs on the device inside the compiled chunk.  ``device_while`` is its
counterpart: a Python loop that reads its condition each turn outside a
graph chunk, and a fixed number of masked bodies inside one
(``algorithms/driver.py::_masked_steps`` sets ``OVERFLOW``), where the
loop sets an overflow flag when it needs more.  The PyTorch of the card
(2.11) has no conditional graph nodes, so the masked bodies are JAX's
``_masked_scan_body`` idea: every body runs and ``torch.where`` keeps the
live ones.
"""

from __future__ import annotations

import torch

from ._device import full, is_dtensor

# While a chunk is built to run without a host read (``_masked_steps``), the
# list that each bounded loop of the current iteration adds its overflow
# flag to; None outside such a chunk, where a loop reads its condition.
OVERFLOW = [None]
# Inside a masked body of an enclosing bounded loop: whether that body is
# live (a 0-d bool tensor), so that a loop nested in it overflows only there.
ENCLOSING = [None]
# Set to a dict to tally, per loop name, how many bodies each Python-form
# loop took (``{name: {bodies: count}}``): the counts the masked bodies
# per loop are chosen from.
TALLY = [None]
# While ``_masked_steps`` builds an iteration: per loop name, the flags of
# the masked bodies its loops ran (whether each ran while the loop's
# condition held); None elsewhere.
GOES = [None]
# The live-trial counter of the masked form: per ``(name, device)``, the
# masked bodies that ran while the loop's condition held, in the iterations
# a graph chunk kept (an overflowed or frozen one counts none), as an int64
# 0-d tensor on the device, added to on the card (``count_live``).  ``RUN``
# counts, per name, the masked bodies of the spans a chunk launched, on the
# host (``count_run``).  ``live_counts`` reads both.
LIVE = {}
RUN = {}


def where(pred, a, b):
    """``torch.where(pred, a, b)``, where a sharded step's replicated
    predicate meets plain tensors that every rank holds whole (its Grams,
    a noise key) as its local value."""
    if is_dtensor(pred) and not is_dtensor(a) and not is_dtensor(b):
        pred = full(pred)
    return torch.where(pred, a, b)


def _select(pred, new, old):
    """``new`` where ``pred`` holds, else ``old``, leaf by leaf (a tuple, a
    list or a dict of tensors)."""
    if isinstance(old, dict):
        return {k: where(pred, new[k], old[k]) for k in old}
    return type(old)(where(pred, a, b) for a, b in zip(new, old))


def device_while(cond, body, state, bound, bodies, name=None):
    """JAX's ``lax.while_loop(cond, body, state)``, with at most ``bound``
    bodies (None: no bound), in the form that fits where it runs:

    * outside a graph chunk (the eager chunks, the CPU, the continuation of
      an overflowed iteration): a Python loop that reads ``cond`` each turn
      (a host sync on the card);
    * inside one (``_masked_steps``): ``bodies`` masked bodies, each
      computed and taken through ``torch.where`` while the condition
      holds, JAX's ``_masked_scan_body`` idea.  Where it still holds after
      them and the bound allows more, the iteration's overflow flag is set:
      the chunk freezes there and the host runs that iteration again in the
      Python form.  Both forms take the same bodies in the same order, so
      they give the same bits.

    ``state`` is a tuple, list or dict of tensors (in the Python form it may
    hold anything ``body`` takes); ``name`` keys the loop in ``TALLY`` and,
    in the masked form, in ``GOES`` (``LIVE``'s input)."""
    flags = OVERFLOW[0]
    if flags is None:
        n = 0
        while (bound is None or n < bound) and bool(full(cond(state))):
            state = body(state)
            n += 1
        if TALLY[0] is not None:
            counts = TALLY[0].setdefault(name, {})
            counts[n] = counts.get(n, 0) + 1
        return state
    outer = ENCLOSING[0]
    go = cond(state) if outer is None else outer & cond(state)
    n = bodies if bound is None else min(bodies, bound)
    goes = None if GOES[0] is None else GOES[0].setdefault(name, [])
    for _ in range(n):
        if goes is not None:
            goes.append(go)
        ENCLOSING[0] = go
        try:
            new = body(state)
        finally:
            ENCLOSING[0] = outer
        state = _select(go, new, state)
        go = go & cond(state)
    if bound is None or n < bound:
        flags.append(go)
    return state


def count_live(goes, keep):
    """Add one iteration's live masked bodies (``goes``, ``GOES``'s dict)
    to ``LIVE`` where ``keep`` (a 0-d bool tensor: the iteration's result
    is kept) holds: three operations a loop name (a stack, a sum and one
    multiply-add into the counter), no host read.  A counter is made on
    the first iteration built outside a capture (a chunk runs one before
    it captures), so that no capture holds its allocation or zeroes it at
    each replay; a name first met inside a capture is not counted."""
    for name, flags in goes.items():
        live = torch.stack([full(f) for f in flags]).sum()
        key = (name, str(live.device))
        if key not in LIVE:
            if live.is_cuda and torch.cuda.is_current_stream_capturing():
                continue
            LIVE[key] = torch.zeros((), dtype=torch.int64, device=live.device)
        LIVE[key].addcmul_(live, keep)


def count_run(bodies):
    """Add the masked bodies of a launched span (``{name: bodies}``) to
    ``RUN``."""
    for name, n in bodies.items():
        RUN[name] = RUN.get(name, 0) + n


def live_counts():
    """``{name: (live, run)}``: the masked bodies that did work and those
    run, per loop name, since the process started (one read a counter)."""
    live = {}
    for (name, _), t in LIVE.items():
        live[name] = live.get(name, 0) + int(t)
    return {name: (live.get(name, 0), RUN.get(name, 0))
            for name in sorted(set(live) | set(RUN), key=str)}
