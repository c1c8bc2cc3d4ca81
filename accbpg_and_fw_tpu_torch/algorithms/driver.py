"""Chunked iteration loop for the port's drivers.

The part of ``accbpg_and_fw_tpu/algorithms/driver.py::run_driver`` that the
D-opt solvers, the Bregman and the Frank-Wolfe drivers need.  A driver is a
step function ``step(carry, k) -> (carry, hist)``; ``carry`` is a dict that
holds a bool ``done`` and ``hist`` a dict of scalars that holds ``_stop``
(the stopping test fired at this iteration, which is the last one
recorded, matching the reference's ``break``).

PyTorch runs eagerly, so a chunk is a Python loop of steps, in one of two
modes chosen by the type of ``carry["done"]``:

* a bool tensor (the D-opt engines, ``FW_alg_descent_step``): the loop
  never reads a tensor back inside a chunk; once ``done`` is set the carry
  freezes through a ``torch.where`` select (as the JAX scan body does), and
  the host reads the chunk's histories and the ``done`` flag once, at the
  chunk boundary (a history of host numbers, such as a step size known in
  advance, needs no read);
* a Python bool (the Bregman drivers, whose line searches read each trial's
  decision back anyway): the step keeps its scalars on the host, returns
  host numbers in ``hist``, and the chunk ends at the stop row, which is
  the iteration the JAX driver's frozen carry stops at.  The carry may mix
  tensors with Python floats, ints and bools.

The chunk boundary is where ``between_chunks`` runs, where checkpoints are
written and where the verbose table is printed.

Checkpoints are the JAX driver's ``.npz`` format (same keys, version and
fingerprint check), so a run resumes iteration-exactly from a file written
by either package.  Not ported: the AOT executable cache and the
``solver_device``/``AUTO_CPU_MAX_SIZE`` host fallback (PyTorch compiles
nothing, and the device is the caller's explicit choice).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import _scalar
from .._device import full

_CKPT_VERSION = 3

# At most one checkpoint save per this many seconds, plus always after the
# final chunk (every save rewrites the whole accumulated history).
CHECKPOINT_MIN_INTERVAL_S = 10.0


def _save_checkpoint(path, carry, blocks, k_next, t_spent, fp):
    """Atomically persist carry + valid history rows + progress marker."""
    payload = {
        "__v": np.asarray(_CKPT_VERSION),
        "__k_next": np.asarray(k_next),
        "__t": np.asarray(t_spent),
        "__fp": np.asarray(fp),
    }
    for k, v in carry.items():
        payload[f"c::{k}"] = (v.detach().cpu().numpy()
                              if isinstance(v, torch.Tensor) else np.asarray(v))
    if blocks:
        for name in blocks[0][0]:
            payload[f"h::{name}"] = np.concatenate(
                [b[0][name] for b in blocks])
    tmp = path + ".tmp.npz"  # np.savez appends .npz unless already present
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def _load_checkpoint(path, carry_proto, fp):
    """Load a checkpoint if present: ``(carry, block, k_next, t_spent)``,
    where ``block`` holds the completed valid history rows (or None)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if "__v" not in z.files or int(z["__v"]) != _CKPT_VERSION:
            raise ValueError(
                f"checkpoint {path!r} has an incompatible format; delete it "
                "to start fresh")
        saved_fp = str(z["__fp"])
        if saved_fp != fp:
            raise ValueError(
                f"checkpoint {path!r} was saved by a different solver "
                f"({saved_fp}); refusing to resume as {fp}. Delete the "
                "file to start fresh.")
        saved_keys = sorted(n[3:] for n in z.files if n.startswith("c::"))
        if saved_keys != sorted(carry_proto.keys()):
            raise ValueError(
                f"checkpoint {path!r} carry keys {saved_keys} do not match "
                f"this solver's state {sorted(carry_proto.keys())}")
        carry = {}
        for k, proto in carry_proto.items():
            saved = z[f"c::{k}"]
            if tuple(saved.shape) != tuple(np.shape(proto)):
                raise ValueError(
                    f"checkpoint {path!r} carry leaf {k!r} has shape "
                    f"{tuple(saved.shape)} but this solve expects "
                    f"{tuple(np.shape(proto))} — different problem instance")
            if isinstance(proto, torch.Tensor):
                carry[k] = torch.as_tensor(saved).to(device=proto.device,
                                                     dtype=proto.dtype)
            elif isinstance(proto, np.ndarray):  # a host array: the key
                carry[k] = saved.astype(proto.dtype)
            else:  # a host scalar: bool, int or float, as the proto
                carry[k] = type(proto)(saved.item())
        hist_names = [n[3:] for n in z.files if n.startswith("h::")]
        block = ({name: z[f"h::{name}"] for name in hist_names}
                 if hist_names else None)
        return carry, block, int(z["__k_next"]), float(z["__t"])


def _frozen_steps(step, carry, k0, limit):
    """Iterations ``k0 <= k < limit`` with tensor scalars and no host read:
    the carry freezes through ``torch.where`` once done.  A host leaf (the
    noise key) cannot freeze without a read: each step's value is kept in
    ``host``, for the caller to restore the one after the last valid row.
    Returns ``(carry, rows, host)``."""
    rows, host = [], [{key: v for key, v in carry.items()
                       if not isinstance(v, torch.Tensor)}]
    for k in range(k0, limit):
        done = carry["done"]
        new, h = step(carry, k)
        h = dict(h)
        h["_valid"] = torch.logical_not(done)
        new = dict(new)
        new["done"] = done | new["done"] | h["_stop"]
        host.append({key: new[key] for key in host[0]})
        carry = {key: (torch.where(done, carry[key], new[key])
                       if key not in host[0] else new[key])
                 for key in carry}
        rows.append(h)
    return carry, rows, host


def _device_chunk(step, carry, k0, limit):
    """``_frozen_steps`` with the histories read once."""
    carry, rows, host = _frozen_steps(step, carry, k0, limit)
    hist = {name: (full(torch.stack([r[name] for r in rows])).cpu().numpy()
                   if isinstance(rows[0][name], torch.Tensor)
                   else np.asarray([r[name] for r in rows]))
            for name in rows[0]}
    carry.update(host[int(hist["_valid"].sum())])
    return carry, hist


def _host_chunk(step, carry, k0, limit):
    """Iterations ``k0 <= k < limit`` of a step with host scalars, ending
    at the stop row (inclusive)."""
    rows = []
    for k in range(k0, limit):
        carry, h = step(carry, k)
        rows.append(dict(h, _valid=True))
        if h["_stop"]:
            carry = dict(carry, done=True)
            break
    hist = {name: np.asarray([r[name] for r in rows]) for name in rows[0]}
    return carry, hist


def scan_full(step, carry, num_iters: int):
    """Run ``num_iters`` iterations of ``step`` with no early exit and no
    host read (the JAX ``scan_full``, one compiled scan there): once
    ``done`` is set the carry freezes through ``torch.where``.  Returns
    ``(carry, hist)`` with ``hist`` the rows stacked into tensors along a
    leading iteration axis, ``_valid`` and ``_stop`` included.  The carry's
    leaves must be tensors (numbers are converted)."""
    carry, rows, _ = _frozen_steps(
        step, {k: torch.as_tensor(v) for k, v in carry.items()}, 0,
        num_iters)
    hist = {name: torch.stack([torch.as_tensor(r[name]) for r in rows])
            for name in (rows[0] if rows else ())}
    return carry, hist


def run_driver(
    step: Callable,
    carry: Dict[str, torch.Tensor],
    maxitrs: int,
    *,
    verbose: bool = True,
    verbskip: int = 1,
    header: Optional[str] = None,
    print_row: Optional[Callable] = None,
    chunk: Optional[int] = None,
    between_chunks: Optional[Callable] = None,
    checkpoint: Optional[str] = None,
    fingerprint: str = "",
    k_start: int = 0,
):
    """Run ``step`` for iterations ``k_start <= k < maxitrs`` in chunks.

    ``between_chunks(carry, k_next) -> carry`` runs on the host between
    chunks.  ``checkpoint``: path of an ``.npz`` saved at chunk boundaries
    (throttled to one save per ``CHECKPOINT_MIN_INTERVAL_S``, the final
    chunk always saved); if it exists when the run starts, the run resumes
    from it exactly, even with another ``chunk`` or a larger budget.
    ``fingerprint`` names the solver; a file saved under another name is
    refused.

    Returns ``(carry, hist, T)``: ``hist`` maps each history name to a host
    numpy array truncated at the stopping iteration (inclusive); ``T`` is
    the wall-time array, interpolated within each chunk.
    """
    if maxitrs <= k_start:
        raise ValueError(f"maxitrs must be > {k_start}")
    chunk = max(1, int(chunk) if chunk else int(max(verbskip, 256)))

    if verbose and header:
        print(header)

    # blocks: list of (valid-rows hist dict, t_a, t_b, rows_launched)
    blocks = []
    k_next = k_start
    t_spent = 0.0
    last_save = None
    if checkpoint is not None:
        state = _load_checkpoint(checkpoint, carry, fingerprint)
        if state is not None:
            carry, block, k_next, t_spent = state
            if block is not None:
                nrows = len(next(iter(block.values())))
                blocks.append((block, 0.0, t_spent, nrows))

    t0 = time.time() - t_spent
    while k_next < maxitrs and not bool(carry["done"]):
        t_a = time.time() - t0
        # the chunk grid is absolute, so hooks fire at the same k whether or
        # not the run was resumed from a checkpoint
        limit = min(maxitrs, (k_next // chunk + 1) * chunk)
        chunk_fn = (_host_chunk if isinstance(carry["done"], bool)
                    else _device_chunk)
        carry, hist = chunk_fn(step, carry, k_next, limit)
        t_b = time.time() - t0
        nv = int(hist["_valid"].sum())
        block = {name: v[:nv] for name, v in hist.items()}
        if _scalar.DEBUG[0] or _scalar.DEBUG[1]:  # diagnostics.debug_mode
            for name, v in block.items():
                if v.dtype.kind == "f":
                    _scalar.check_finite(v.tolist(),
                                         f"the {name!r} history of a chunk")
        launched = len(hist["_valid"])
        blocks.append((block, t_a, t_b, launched))

        if verbose and print_row is not None:
            for j in range(nv):
                k = k_next + j
                if k % verbskip == 0:
                    row = {name: v[j] for name, v in block.items()}
                    print_row(k, row, t_a + (t_b - t_a) * j / launched)

        k_next += nv
        done = bool(carry["done"])
        # the hook runs BEFORE the save, so a checkpoint holds exactly the
        # carry the next chunk consumes and resume replays the run bitwise
        if between_chunks is not None and not done and k_next < maxitrs:
            carry = between_chunks(carry, k_next)
        if checkpoint is not None:
            now = time.time()
            final = done or k_next >= maxitrs
            if (final or last_save is None
                    or now - last_save >= CHECKPOINT_MIN_INTERVAL_S):
                _save_checkpoint(checkpoint, carry, blocks, k_next,
                                 now - t0, fingerprint)
                last_save = now
        if done:
            break

    # concatenate + truncate with the reference's inclusive-stop semantics
    full = {name: np.concatenate([b[0][name] for b in blocks])
            for name in blocks[0][0].keys()}
    full.pop("_valid", None)
    full.pop("_stop", None)
    n = min(len(next(iter(full.values()))), maxitrs - k_start)
    out = {name: v[:n] for name, v in full.items()}

    # each block's rows spread linearly over its measured [t_a, t_b]
    T = np.zeros(n)
    pos = 0
    for block, t_a, t_b, launched in blocks:
        nb = min(len(next(iter(block.values()))), n - pos)
        if nb <= 0:
            break
        T[pos:pos + nb] = t_a + (t_b - t_a) * np.arange(nb) / max(launched, 1)
        pos += nb
    out["T"] = T
    return carry, out, T
