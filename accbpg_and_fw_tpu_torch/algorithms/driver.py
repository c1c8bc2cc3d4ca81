"""Chunked iteration loop for the port's drivers.

The port of ``accbpg_and_fw_tpu/algorithms/driver.py::run_driver``.  A
driver is a step function in JAX's cached form, ``step(cfg, problem,
carry, k) -> (carry, hist)`` with ``cfg`` a hashable config and
``problem`` the solve's data (tensors, numbers, oracles), or in the
closure form ``step(carry, k)`` (``problem=None``).  ``carry`` is a dict
that holds a bool ``done`` and ``hist`` a dict of scalars that holds
``_stop`` (the stopping test fired at this iteration, which is the last
one recorded, matching the reference's ``break``).

A chunk runs in one of two ways, chosen from the carry's types and
device before anything runs (``chunk_mode``):

* ``"graph"``: ``done`` and every other leaf a tensor on one CUDA
  device (plain, or a DTensor of one mesh whose shard on this rank lies
  there), and no oracle of the problem that reads the host inside its
  calls (``host_reads``): the exact D-opt engine, the FW and Bregman
  drivers' steps (the ``fast_gram`` steps too, and the stochastic runs:
  the noise key is a device tensor, ``_rng``), the extras, and their
  sharded solves, whose collectives (NCCL) are captured with them.  The
  chunk is captured once as a ``torch.cuda.CUDAGraph`` of ``span`` iterations
  (the whole chunk unless the caller asks for fewer) and replayed back to
  back until the chunk is done, the counterpart of JAX's compiled chunk: the carry, the
  problem's tensors (those of its oracles included) and the first
  iteration ``k0`` go in through static buffers, ``k`` reaches the step as
  an int64 tensor on the card (JAX passes a traced int32), and the
  histories come out of a device buffer read once per chunk.  A partial
  last chunk replays the same graph with a device ``limit`` past which the
  carry freezes, as JAX's ``_masked_scan_body``; only the real stop
  persists into the carry.  A data-dependent loop inside a step (a line
  search, a Newton solve) is a ``device_while``: in the graph it is a fixed
  number of masked bodies, and an iteration whose loop needs more sets an
  overflow flag that freezes the carry there without stopping the run;
  the host reads the flag after each span, launches no span after one
  that overflowed, runs that one iteration again on the card in the
  loop's Python form, and replays from the next one
  (``GRAPH_STATS["continuations"]``).  Graphs are cached within the
  process on JAX's key (step, cfg, chunk, span, and the shapes, dtypes and
  devices of problem and carry; see ``graph_key``), so a second solve of
  the same shapes replays without a new capture.  A capture that fails
  raises: nothing falls back to the eager loop.
* ``"eager"``: the same frozen steps run one Python dispatch at a time
  with no read inside a chunk but those of the steps' own loops
  (``device_while`` in its Python form reads its condition each turn;
  ``k`` a host int), for a carry on the CPU (where the tests run it), a
  carry with a host leaf (a number, which the first step makes a
  tensor), DTensors of two meshes, and a problem whose oracle reads the
  host (``host_reads``: a user's oracle that declares it; none of the
  port's does).  Once ``done`` is set the carry freezes through a
  ``torch.where`` select, as the JAX scan body does.  A sharded chunk
  reduces its partial sums before an operation takes them
  (``_ReducedPartials``), in a graph as eagerly.

The chunk boundary is where ``between_chunks`` runs, where checkpoints are
written and where the verbose table is printed.

Checkpoints are the JAX driver's ``.npz`` format (same keys, version and
fingerprint check, the fingerprint JAX's ``_fingerprint(step, cfg)``), so
a run resumes iteration-exactly from a file written by either package.
Not ported: the AOT executable cache on disk (a graph is captured in the
process that replays it) and the ``solver_device``/``AUTO_CPU_MAX_SIZE``
host fallback (the device is the caller's explicit choice).
"""

from __future__ import annotations

import contextlib
import copy
import functools
import os
import time
import types
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from .. import _loops, _rng, _scalar, diagnostics
from .._device import full, is_dtensor, replicated

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
        if k == "key" and isinstance(v, torch.Tensor):
            # the noise key's int64 words saved as JAX's uint32[2]
            payload["c::key"] = _rng.host_words(v)
            continue
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
                # a key saved as uint32 words widens to the proto's int64
                carry[k] = torch.as_tensor(
                    saved.astype(_np_dtype(proto.dtype))).to(proto.device)
            else:  # a host scalar: bool, int or float, as the proto
                carry[k] = type(proto)(saved.item())
        hist_names = [n[3:] for n in z.files if n.startswith("h::")]
        block = ({name: z[f"h::{name}"] for name in hist_names}
                 if hist_names else None)
        return carry, block, int(z["__k_next"]), float(z["__t"])


_PKG = __name__.split(".")[0]

# Captured chunks, least recently used first.  Each holds its static
# buffers and its private memory pool on the card until it is evicted.
_GRAPHS: OrderedDict = OrderedDict()
_GRAPH_CACHE_CAP = 16

# Process-wide counts of the graph chunks: captures, replays (one per graph
# launch, so a chunk of several spans counts each), and continuations:
# iterations whose bounded loops overflowed in a replay and ran again
# eagerly.  Their host time is in the spans ``graph.capture``,
# ``graph.replay``, ``graph.read`` and ``graph.continuation``.
GRAPH_STATS = {"captures": 0, "replays": 0, "continuations": 0}

_EAGER = [False]


def clear_graph_cache():
    """Drop every captured chunk (and the card memory it holds)."""
    _GRAPHS.clear()


class eager_chunks:
    """Context manager: chunks that would run as a graph run eagerly
    inside the block (to hold a graph against the eager loop)."""

    def __enter__(self):
        self._prev, _EAGER[0] = _EAGER[0], True
        return self

    def __exit__(self, *exc):
        _EAGER[0] = self._prev


def _fingerprint(step, cfg):
    """JAX's ``_fingerprint(step, cfg)`` for a step of this package: the
    step's module (under the JAX package's name) and name, and the
    config's repr where it holds no object address, else its type name."""
    name = getattr(step, "__qualname__", None) or repr(step)
    mod = getattr(step, "__module__", None) or "?"
    if mod.split(".")[0] == _PKG:
        mod = "accbpg_and_fw_tpu" + mod[len(_PKG):]
    r = repr(cfg)
    return f"{mod}.{name}|{type(cfg).__name__ if '0x' in r else r}"


def host_reads(problem, cfg=None):
    """Whether an oracle of the problem (a value of the problem dict) or a
    callable of the config (a field such as the LMO) declares
    ``host_reads``: it reads values back inside its calls (a blocked inner
    loop, an SVD's convergence check), so its steps cannot be captured."""
    values = list(problem.values()) if isinstance(problem, dict) else []
    if isinstance(cfg, tuple):
        values += list(cfg)
    return any(getattr(v, "host_reads", False) for v in values)


def chunk_mode(carry, problem=None, cfg=None):
    """How a chunk of this carry runs: ``"graph"`` where every leaf is a
    tensor on one CUDA device, a plain tensor or a DTensor of one mesh
    whose shard on this rank lies there (outside ``eager_chunks``), and no
    oracle of ``problem`` and no callable of ``cfg`` reads the host; else
    ``"eager"`` (a CPU carry, a host leaf, DTensors of two meshes, or
    ``host_reads``)."""
    if _EAGER[0]:
        return "eager"
    leaves = list(carry.values())
    if not all(isinstance(v, torch.Tensor) for v in leaves):
        return "eager"
    if len({v.device_mesh for v in leaves if is_dtensor(v)}) > 1:
        return "eager"
    # a DTensor's device is its local shard's
    devices = {v.device for v in leaves}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        return "eager"
    if host_reads(problem, cfg):
        return "eager"
    return "graph"


# held by identity in a graph key: code, and what has no attributes to walk
_OPAQUE = (types.FunctionType, types.MethodType, types.BuiltinFunctionType,
           types.ModuleType, type, functools.partial)
_DEPTH = 4  # objects nested deeper than this are held by identity


def _walked(tree, depth):
    """Whether ``_spec`` describes ``tree`` by its attributes (an oracle)."""
    return (depth < _DEPTH and hasattr(tree, "__dict__")
            and not isinstance(tree, _OPAQUE))


def _tensor_spec(t):
    """A tensor's shape, dtype and device; a DTensor's global and local
    shapes, dtype, device, placements and mesh (device type, shape and
    ranks), so that no solve replays a graph of another mesh or
    placement."""
    spec = (tuple(t.shape), str(t.dtype), str(t.device))
    if not is_dtensor(t):
        return spec
    mesh = t.device_mesh
    return spec + (tuple(t.to_local().shape), tuple(t.placements),
                   mesh.device_type, tuple(mesh.shape),
                   tuple(mesh.mesh.flatten().tolist()))


def _spec(tree, leaves, keep, depth=0):
    """A hashable description of ``tree`` with its tensors appended to
    ``leaves`` (each described by ``_tensor_spec``): dicts, lists,
    tuples, numbers, strings, devices and dtypes by value, an object with
    attributes (an oracle) by its type and attributes, anything else (a
    function, a closure such as an LMO) by identity, kept alive in
    ``keep`` so that the identity stays its own."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("tensor",) + _tensor_spec(tree)
    if tree is None or isinstance(tree, (bool, int, float, str,
                                         torch.device, torch.dtype)):
        return (type(tree).__name__, tree)
    sub = functools.partial(_spec, leaves=leaves, keep=keep, depth=depth + 1)
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, sub(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree),) + tuple(sub(v) for v in tree)
    if _walked(tree, depth):
        return (type(tree),) + tuple((k, sub(v))
                                     for k, v in sorted(vars(tree).items()))
    keep.append(tree)
    return ("id", id(tree))


def _rebuild(tree, leaves, depth=0):
    """``tree`` with its tensors, in ``_spec``'s order, replaced by the next
    of the iterator ``leaves`` (a walked object becomes a shallow copy)."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    sub = functools.partial(_rebuild, leaves=leaves, depth=depth + 1)
    if isinstance(tree, dict):
        return {k: sub(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [sub(v) for v in tree]
    if isinstance(tree, tuple):
        vals = [sub(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if _walked(tree, depth):
        out = copy.copy(tree)
        for k in sorted(vars(tree)):
            setattr(out, k, sub(getattr(tree, k)))
        return out
    return tree


def _as_device_numbers(problem, device):
    """A problem dict with its numbers as 0-d tensors on ``device`` (JAX's
    ``tree_map(jnp.asarray, problem)``), so that a capture reads them from
    static buffers instead of baking them in."""
    if not isinstance(problem, dict):
        return problem

    def conv(v):
        # a fill on the card: no copy from the host
        for kind, dtype in ((bool, torch.bool), (int, torch.int64),
                            (float, torch.float64)):
            if isinstance(v, kind):
                return torch.full((), v, dtype=dtype, device=device)
        return v

    return {k: conv(v) for k, v in problem.items()}


def graph_key(step, cfg, chunk, problem, carry, span=None):
    """The cache key of a captured chunk, JAX's ``_get_compiled_chunk``
    key: the step, the config, the chunk length, the iterations per graph
    (``span``, None for the whole chunk), and the structure, shapes, dtypes
    and devices of problem and carry.  Returns ``(key, leaves, keep)``: the
    problem's tensors in order, and the objects the key names by identity
    (the entry keeps them alive)."""
    leaves, keep = [], []
    pspec = _spec(problem, leaves, keep)
    cspec = tuple((k,) + _tensor_spec(v) for k, v in sorted(carry.items()))
    return (step, cfg, int(chunk), span, pspec, cspec), leaves, keep


def _masked_steps(step, carry, k0, limit, n, halted=None, bodies=None):
    """``n`` iterations ``k = k0, k0 + 1, ...`` (``k0`` and ``limit`` 0-d
    int64 tensors) with no host read: the carry freezes once ``done`` is
    set or past ``limit``, and only the real stop persists into the carry
    (JAX's ``_masked_scan_body``).  The steps' ``device_while`` loops take
    their masked form; from the first iteration where one overflowed the
    carry freezes too, without a stop (``halted``, a 0-d bool tensor that a
    chunk carries over its spans, says that one did before).  The live
    masked bodies of each kept iteration go to ``_loops.LIVE`` on the
    device; ``bodies``, where given, is a dict that gets, per loop name, the
    masked bodies the ``n`` iterations run.  Returns the carry and the
    histories packed into one float64 tensor (names x n) with their names
    and dtypes; ``_done`` is the carry's flag and ``_halt`` the overflow's
    after each row."""
    if halted is None:
        halted = torch.zeros((), dtype=torch.bool, device=k0.device)
    ks = k0 + torch.arange(n, device=k0.device)
    rows = []
    with _sharded_scope(carry):
        for i in range(n):
            k = ks[i]
            frozen = carry["done"] | (k >= limit) | halted
            flags, goes = [], {}
            _loops.OVERFLOW[0], _loops.GOES[0] = flags, goes
            try:
                new, h = step(carry, k)
            finally:
                _loops.OVERFLOW[0] = _loops.GOES[0] = None
            hold = frozen
            if flags:
                over = torch.stack([full(f) for f in flags]).any()
                hold = frozen | over
                halted = halted | (over & torch.logical_not(frozen))
            h = dict(h)
            h["_valid"] = torch.logical_not(hold)
            if goes:
                _loops.count_live(goes, full(h["_valid"]))
                if bodies is not None:
                    for name, g in goes.items():
                        bodies[name] = bodies.get(name, 0) + len(g)
            new = dict(new)
            new["done"] = carry["done"] | new["done"] | h["_stop"]
            carry = {key: _loops.where(hold, carry[key],
                                       _settled(new[key])) for key in carry}
            h["_done"] = carry["done"]  # the carry's flag, read with the rows
            h["_halt"] = halted
            rows.append(h)
    names = list(rows[0])
    dtypes = [r.dtype if isinstance(r, torch.Tensor) else
              torch.float64 for r in rows[0].values()]

    def dev_row(v):
        # a sharded step's scalars are replicated: their local values
        return (full(v) if isinstance(v, torch.Tensor) else
                torch.full((), v, dtype=torch.float64, device=k0.device))

    packed = torch.stack([torch.stack([dev_row(r[name]) for r in rows])
                          .to(torch.float64) for name in names])
    return carry, packed, names, dtypes


def _local(t):
    """The tensor that holds ``t``'s values on this rank: a DTensor's
    local shard, a plain tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def _static(t):
    """A static buffer for the tensor ``t`` and the tensor a captured step
    sees: a clone of its local tensor, and for a DTensor a DTensor of the
    same mesh, placements, shape and stride around that clone (a pending
    partial sum reduced first, as ``_settled``)."""
    t = _settled(t)
    buf = _local(t).clone()
    if not is_dtensor(t):
        return buf, buf
    from torch.distributed.tensor import DTensor

    return buf, DTensor.from_local(buf, t.device_mesh, t.placements,
                                   run_check=False, shape=t.shape,
                                   stride=t.stride())


def _copy_into(buf, view, v):
    """``v`` into the static buffer ``buf`` behind ``view``: a DTensor in
    other placements (a pending partial sum) is redistributed to
    ``view``'s first, and one met by a plain buffer (a leaf that a sharded
    step made a DTensor, a flag that started plain) goes in whole."""
    if is_dtensor(v):
        if not is_dtensor(view):
            v = full(v)
        elif tuple(v.placements) != tuple(view.placements):
            v = v.redistribute(view.device_mesh, view.placements)
    buf.copy_(_local(v))


def _sharded_scope(carry):
    """What ``carry``'s steps, and a driver's set-up of it, run under:
    ``_ReducedPartials`` where a leaf is a DTensor (eagerly and in a graph
    alike, so both reduce the same partial sums at the same
    operations)."""
    if any(is_dtensor(v) for v in carry.values()):
        return _ReducedPartials()
    return contextlib.nullcontext()


def _node_count(graph):
    """The nodes of a kept CUDA graph (the driver API's ``cuGraphGetNodes``
    on ``raw_cuda_graph()``), or None where the driver does not answer."""
    import ctypes

    try:
        get = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
        get.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.POINTER(ctypes.c_size_t)]
        get.restype = ctypes.c_int
        n = ctypes.c_size_t(0)
        if get(ctypes.c_void_p(graph.raw_cuda_graph()), None,
               ctypes.byref(n)):
            return None
    except (OSError, AttributeError, RuntimeError):
        return None
    return n.value


class _GraphChunk:
    """A chunk of ``chunk`` iterations as replays of a CUDA graph of
    ``span`` iterations, with its static buffers: the carry and the
    overflow flag (read at the start of a replay and written at its end),
    the problem's tensors, ``k0``, ``limit``, the packed histories of a
    replay and those of the chunk.  A DTensor's static buffer is its local
    shard, and the captured step sees a DTensor of the same placements
    around it; the collectives of a sharded step are captured with it.
    ``nodes`` is the captured graph's node count, set at the capture.
    On the CPU (where the tests run the same
    code) nothing is captured: a replay runs ``_masked_steps``, and
    ``nodes`` is None."""

    def __init__(self, step, cfg, chunk, problem, leaves, carry, keep,
                 cached, span=None):
        dev = carry["done"].device
        self.keep = keep
        self.span = min(int(span or chunk), chunk)
        pairs = [_static(t) for t in leaves]
        self.leaves = [buf for buf, _ in pairs]
        self.problem = _rebuild(problem, iter(view for _, view in pairs))
        self.bufs, self.carry = {}, {}
        for k, v in carry.items():
            self.bufs[k], self.carry[k] = _static(v)
        self.k0 = torch.zeros((), dtype=torch.int64, device=dev)
        self.limit = torch.zeros((), dtype=torch.int64, device=dev)
        self.halted = torch.zeros((), dtype=torch.bool, device=dev)
        # the step on this entry's problem; a closure over ``self`` would be
        # a reference cycle, freed by the collector at any moment, a
        # capture's included
        self.run = (functools.partial(step, cfg, self.problem) if cached
                    else step)
        self.graph, self.capture_s, self.pool_bytes = None, 0.0, 0
        self.nodes = None
        self.bodies = {}  # masked bodies a span runs, per loop name
        if dev.type != "cuda":
            _, _, self.names, self.dtypes = _masked_steps(
                self.run, self.carry, self.k0, self.limit, 1, self.halted)
            self.rows = self._rows(chunk, dev)
            return
        with diagnostics.span("graph.capture"):
            self._capture(chunk, dev)
        GRAPH_STATS["captures"] += 1

    def _capture(self, chunk, dev):
        """Capture the graph of a span, and count its nodes."""
        t = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # one step outside the capture: the libraries' handles and
            # workspaces, and a sharded step's NCCL communicator, exist
            # before the capture needs them
            _masked_steps(self.run, self.carry, self.k0, self.limit, 1,
                          self.halted)
        torch.cuda.current_stream(dev).wait_stream(side)
        # the graph is kept beside its executable, so that its nodes can
        # be counted (``raw_cuda_graph``)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph, stream=side):
            # entering emptied the allocator's cache: what is reserved
            # from here on is the graph's private pool
            before = torch.cuda.memory_reserved(dev)
            out, self.hist, self.names, self.dtypes = _masked_steps(
                self.run, self.carry, self.k0, self.limit, self.span,
                self.halted, self.bodies)
            self._store(out)
        self.graph.instantiate()
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t
        self.nodes = _node_count(self.graph)
        self.rows = self._rows(chunk, dev)
        static = self.leaves + list(self.bufs.values())
        # card memory the entry holds: its pool and its static buffers
        self.pool_bytes = (torch.cuda.memory_reserved(dev) - before
                           + sum(a.numel() * a.element_size()
                                 for a in static + [self.hist]
                                 + ([self.rows] if self.rows is not None
                                    else [])))

    def _rows(self, chunk, dev):
        """The chunk's packed histories, where it takes several spans (its
        last span may run past the chunk, masked by ``limit``)."""
        if self.span >= chunk:
            return None
        spans = -(-chunk // self.span)
        return torch.empty((len(self.names), spans * self.span),
                           dtype=torch.float64, device=dev)

    def load_problem(self, leaves):
        """A new problem's tensors (their local shards) into the static
        buffers."""
        for dst, src in zip(self.leaves, leaves):
            src = _local(src)
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)

    def _store(self, carry):
        """A span's carry and overflow into the static buffers."""
        for k, v in carry.items():
            _copy_into(self.bufs[k], self.carry[k], v)
        self.halted.copy_(self.hist[self.names.index("_halt"), -1] != 0)

    def _launch(self):
        """One span from the static buffers; its masked bodies counted in
        ``_loops.RUN``."""
        if self.graph is not None:
            self.graph.replay()
        else:
            self.bodies = {}
            out, self.hist, _, _ = _masked_steps(
                self.run, self.carry, self.k0, self.limit, self.span,
                self.halted, self.bodies)
            self._store(out)
        _loops.count_run(self.bodies)

    def replay(self, carry, k0, limit):
        """Run iterations ``k0 <= k < limit`` (at most a chunk) from
        ``carry``, span after span; returns the carry (the static
        buffers), the host histories, the carry's ``done`` and whether an
        iteration overflowed (its row and those after it are invalid), all
        read in one copy.  Between spans the overflow flag is read, and no
        span is launched after one that overflowed: the rest of the chunk
        waits for the continuation.  (Launching the next span before the
        read would keep the card busy through the read, but would replay
        a whole span frozen at every continuation.)"""
        for k, v in carry.items():
            if v is not self.carry[k]:
                _copy_into(self.bufs[k], self.carry[k], v)
        self.halted.fill_(False)
        self.limit.fill_(limit)
        spans = -(-(limit - k0) // self.span)
        for j in range(spans):
            self.k0.fill_(k0 + j * self.span)
            with diagnostics.span("graph.replay"):
                self._launch()
            if spans > 1:
                self.rows[:, j * self.span:(j + 1) * self.span].copy_(
                    self.hist)
            if j + 1 < spans:
                with diagnostics.span("graph.read"):
                    halted = bool(self.halted)
                if halted:
                    spans = j + 1
                    break
        GRAPH_STATS["replays"] += spans
        with diagnostics.span("graph.read", rows=True):
            packed = (self.hist if spans == 1 else
                      self.rows[:, :spans * self.span]).cpu().numpy()
        hist = {name: packed[i].astype(_np_dtype(dt))
                for i, (name, dt) in enumerate(zip(self.names, self.dtypes))}
        return (dict(self.carry), hist, bool(hist.pop("_done")[-1]),
                bool(hist.pop("_halt")[-1]))


def _graph_run(graph, step, carry, k0, limit):
    """Iterations ``k0 <= k < limit`` by replays of ``graph``, one read
    each: an iteration whose bounded loops overflowed runs again by
    ``step`` in the loops' Python form, on the same device with the same
    arithmetic, and the replays resume after it.  Returns ``(carry, hist,
    done)``."""
    parts = []
    while True:
        carry, hist, done, halted = graph.replay(carry, k0, limit)
        if not halted:
            parts.append(hist)
            break
        nv = int(hist["_valid"].sum())
        parts.append({name: v[:nv] for name, v in hist.items()})
        k0 += nv
        GRAPH_STATS["continuations"] += 1
        with diagnostics.span("graph.continuation"):
            carry, row = _device_chunk(step, dict(carry), k0, k0 + 1)
        parts.append(row)
        k0 += 1
        done = bool(full(carry["done"]))
        if done or k0 >= limit:
            break
    if len(parts) == 1:
        return carry, parts[0], done
    return carry, {name: np.concatenate([p[name] for p in parts])
                   for name in parts[0]}, done


def _np_dtype(dt):
    return torch.empty((), dtype=dt).numpy().dtype


def _graph_chunk(step, cfg, chunk, problem, carry, cached=True, span=None):
    """The ``_GraphChunk`` for this solve, its static problem buffers
    loaded with this problem's tensors: from the cache for the cached step
    form (captured on a miss), captured for this call alone for the
    closure form, as JAX compiles a closure per call."""
    key, leaves, keep = graph_key(step, cfg, chunk, problem, carry, span)
    if not cached:
        return _GraphChunk(step, cfg, chunk, problem, leaves, carry, keep,
                           False, span)
    entry = _GRAPHS.get(key)
    if entry is None:
        entry = _GraphChunk(step, cfg, chunk, problem, leaves, carry, keep,
                            True, span)
        _GRAPHS[key] = entry
        while len(_GRAPHS) > _GRAPH_CACHE_CAP:
            _GRAPHS.popitem(last=False)
    else:
        entry.load_problem(leaves)
    _GRAPHS.move_to_end(key)
    return entry


def _frozen_steps(step, carry, k0, limit):
    """Iterations ``k0 <= k < limit`` with tensor scalars and no host read:
    the carry freezes through ``torch.where`` once done.  Returns
    ``(carry, rows)``."""
    rows = []
    carry = _settled(carry)
    for k in range(k0, limit):
        done = carry["done"]
        new, h = step(carry, k)
        h = dict(h)
        h["_valid"] = torch.logical_not(done)
        new = dict(new)
        new["done"] = done | new["done"] | h["_stop"]
        carry = {key: _loops.where(done, carry[key], _settled(new[key]))
                 for key in carry}
        rows.append(h)
    return carry, rows


def _settled(tree):
    """A carry (or one leaf) with no pending partial sum: a sharded step's
    partial leaf (a gradient summed over sharded samples) is reduced as it
    enters the carry, eagerly and in a graph alike, so both carry the same
    placements from iteration to iteration and across a graph's spans
    (whose static buffers hold no partial value)."""
    if isinstance(tree, dict):
        return {k: _settled(v) for k, v in tree.items()}
    if is_dtensor(tree) and any(p.is_partial() for p in tree.placements):
        return replicated(tree)
    return tree


class _ReducedPartials(TorchFunctionMode):
    """Inside a sharded chunk, eager or in a graph, and a driver's set-up
    before it: each DTensor that holds a partial (a sum or an extreme over
    a sharded axis: a gradient summed over sharded samples, a scalar) is
    reduced before an operation takes it, as XLA reduces a sharded
    contraction where it ends.  DTensor passes a partial sum through some
    operations that are not linear in it (``torch.div(1.0, g)`` of a
    ``Partial`` g stays ``Partial``, each rank's reciprocal summed): a
    partial gradient met by a nonlinear prox gave another iterate.  And
    its dispatch cache cannot take a partial scalar met by a Python
    number and later by a tensor (``Partial + 0.0`` before ``Partial +
    Replicate`` raises)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        def rep(a):
            if is_dtensor(a) and any(p.is_partial() for p in a.placements):
                return replicated(a)
            return a

        return func(*map(rep, args),
                    **{k: rep(v) for k, v in (kwargs or {}).items()})


def _device_chunk(step, carry, k0, limit):
    """``_frozen_steps`` with the histories read once."""
    with _sharded_scope(carry):
        carry, rows = _frozen_steps(step, carry, k0, limit)
    hist = {name: (full(torch.stack([r[name] for r in rows])).cpu().numpy()
                   if isinstance(rows[0][name], torch.Tensor)
                   else np.asarray([r[name] for r in rows]))
            for name in rows[0]}
    return carry, hist


def scan_full(step, carry, num_iters: int):
    """Run ``num_iters`` iterations of ``step`` with no early exit and no
    host read (the JAX ``scan_full``, one compiled scan there; here the
    eager frozen steps): once ``done`` is set the carry freezes through
    ``torch.where``.  Returns ``(carry, hist)`` with ``hist`` the rows
    stacked into tensors along a leading iteration axis, ``_valid`` and
    ``_stop`` included.  The carry's leaves must be tensors (numbers are
    converted)."""
    carry, rows = _frozen_steps(
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
    problem=None,
    cfg=None,
    k_start: int = 0,
    graph_span: Optional[int] = None,
):
    """Run ``step`` for iterations ``k_start <= k < maxitrs`` in chunks.

    Two step forms, as in JAX: the cached form ``step(cfg, problem, carry,
    k)`` with ``problem`` given (a graph chunk is cached across solves of
    the same shapes), and the closure form ``step(carry, k)`` for
    ``problem=None`` (a graph chunk is cached for this step object).

    ``between_chunks(carry, k_next) -> carry`` runs on the host between
    chunks.  ``checkpoint``: path of an ``.npz`` saved at chunk boundaries
    (throttled to one save per ``CHECKPOINT_MIN_INTERVAL_S``, the final
    chunk always saved); if it exists when the run starts, the run resumes
    from it exactly, even with another ``chunk`` or a larger budget.  The
    file records JAX's fingerprint of ``(step, cfg)``; a file saved under
    another is refused.  ``graph_span``: the iterations a graph chunk
    captures (the whole chunk for None), replayed back to back to fill the
    chunk, still with one read per chunk.

    Returns ``(carry, hist, T)``: ``hist`` maps each history name to a host
    numpy array truncated at the stopping iteration (inclusive); ``T`` is
    the wall-time array, interpolated within each chunk.  The run is the
    span ``driver.solve``.
    """
    with diagnostics.span("driver.solve", **_solve_attrs(step, problem)):
        return _run_chunks(step, carry, maxitrs, verbose, verbskip, header,
                           print_row, chunk, between_chunks, checkpoint,
                           problem, cfg, k_start, graph_span)


def _solve_attrs(step, problem):
    """The ``driver.solve`` span's attributes: the step's name and the
    problem's f-oracle's own (``span_attrs``).  Computed only while the
    recorder is on."""
    if diagnostics.SPANS[0] is None:
        return {}
    f = problem.get("f") if isinstance(problem, dict) else None
    return {"driver": getattr(step, "__name__", type(step).__name__),
            **(f.span_attrs() if hasattr(f, "span_attrs") else {})}


def _run_chunks(step, carry, maxitrs, verbose, verbskip, header, print_row,
                chunk, between_chunks, checkpoint, problem, cfg, k_start,
                graph_span):
    """``run_driver``'s chunks, captures and checkpoints."""
    if maxitrs <= k_start:
        raise ValueError(f"maxitrs must be > {k_start}")
    chunk = max(1, int(chunk) if chunk else int(max(verbskip, 256)))
    fp = _fingerprint(step, cfg)
    if problem is not None:
        raw = step
        step = lambda c, k: raw(cfg, problem, c, k)  # noqa: E731

    if verbose and header:
        print(header)

    # blocks: list of (valid-rows hist dict, t_a, t_b, rows_launched)
    blocks = []
    k_next = k_start
    t_spent = 0.0
    last_save = None
    if checkpoint is not None:
        state = _load_checkpoint(checkpoint, carry, fp)
        if state is not None:
            carry, block, k_next, t_spent = state
            if block is not None:
                nrows = len(next(iter(block.values())))
                blocks.append((block, 0.0, t_spent, nrows))

    mode = chunk_mode(carry, problem, cfg)
    graph = None
    if mode == "graph":
        # chosen from the carry before any capture; JAX's cached form
        # passes the problem as arguments, so its tensors (and numbers)
        # go in through static buffers
        if problem is not None:
            graph = _graph_chunk(
                raw, cfg, chunk,
                _as_device_numbers(problem, carry["done"].device), carry,
                span=graph_span)
        else:
            graph = _graph_chunk(step, None, chunk, None, carry,
                                 cached=False, span=graph_span)

    t0 = time.time() - t_spent
    done = bool(full(carry["done"]))
    while k_next < maxitrs and not done:
        t_a = time.time() - t0
        # the chunk grid is absolute, so hooks fire at the same k whether or
        # not the run was resumed from a checkpoint
        limit = min(maxitrs, (k_next // chunk + 1) * chunk)
        if graph is not None:
            carry, hist, done = _graph_run(graph, step, carry, k_next, limit)
        else:
            carry, hist = _device_chunk(step, carry, k_next, limit)
            done = bool(full(carry["done"]))
        launched = len(hist["_valid"])
        t_b = time.time() - t0
        nv = int(hist["_valid"].sum())
        block = {name: v[:nv] for name, v in hist.items()}
        if _scalar.DEBUG[0] or _scalar.DEBUG[1]:  # diagnostics.debug_mode
            for name, v in block.items():
                if v.dtype.kind == "f":
                    _scalar.check_finite(v.tolist(),
                                         f"the {name!r} history of a chunk")
        blocks.append((block, t_a, t_b, launched))

        if verbose and print_row is not None:
            for j in range(nv):
                k = k_next + j
                if k % verbskip == 0:
                    row = {name: v[j] for name, v in block.items()}
                    print_row(k, row, t_a + (t_b - t_a) * j / launched)

        k_next += nv
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
                                 now - t0, fp)
                last_save = now

    if graph is not None:
        # the static buffers belong to the cached graph: a later replay
        # must not overwrite what this solve returns
        carry = {k: v.clone() for k, v in carry.items()}

    # concatenate + truncate with the reference's inclusive-stop semantics
    joined = {name: np.concatenate([b[0][name] for b in blocks])
              for name in blocks[0][0].keys()}
    joined.pop("_valid", None)
    joined.pop("_stop", None)
    n = min(len(next(iter(joined.values()))), maxitrs - k_start)
    out = {name: v[:n] for name, v in joined.items()}

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
