"""The noise stream of stochastic (inexact) oracles: JAX's threefry2x32.

The JAX drivers draw every noise sample from a linear chain of PRNG keys,
``(key, sub) = split(key)``, and hand ``sub`` to one draw.  The port keeps
that chain and computes JAX's own bits: ``jax.random``'s default
generator, the counter-based hash threefry2x32 in its partitionable
layout (``jax_threefry_partitionable``, on by default since jax 0.5).  A
key is JAX's two 32-bit words (``PRNGKey(seed)``: high word, low word),
held as an int64[2] tensor on the solve's device, so a driver's carry is
all device tensors and a graph chunk can capture its draws; a checkpoint
saves it as JAX's ``uint32[2]`` and the packages resume each other's runs.

* ``split(key)`` is ``jax.random.split``: the hash of the counters (0, 0)
  and (0, 1) under ``key``, the next key and the draw key;
* ``uniform(sub)`` is ``jax.random.uniform(sub, dtype=float64)``: the
  top 52 bits of the 64-bit word of counter (0, 0) as the mantissa;
* ``normal(sub, shape)`` is ``jax.random.normal(sub, shape, float64)``:
  element i hashes the counter (i >> 32, i & 0xffffffff), its uniform on
  ``(nextafter(-1, 0), 1)`` goes through ``sqrt(2) erfinv``.  torch's
  ``erfinv`` (and CUDA's) is not XLA's polynomial, so a normal may part
  from JAX's in its last bits (tests/test_torch_rng_device.py measures
  how far); the uniform it starts from is JAX's bit for bit;
* ``split_uniform(key, scale)`` is ``split`` and the ``uniform`` of the
  draw key (times ``scale``) in one call, the inexact drivers'
  per-iteration ``noise * uniform(sub)``;
* ``split_noise(key, shape, shift, scale, base)`` is ``split`` and
  ``base + (normal(sub, shape) - shift) * scale`` in one call: what JAX
  compiles into one fused expression for a stochastic oracle's gradient
  (the split in the driver, the noise in ``FrobeniusSymLoss._noise``).

The hash is stateless, so a key gives the same bits in a graph, in a
masked body that dies, eagerly and on the CPU.  On a CUDA key each
function launches the kernel ``csrc/threefry.cu`` on the current stream,
once: entry ``threefry_split_run`` for a split (one thread),
``threefry_draw_run`` for a draw or a ``split_noise`` (``DRAW_PLAN``: the
threads a block and the counters a thread); each launch is counted on the
host (``SPLIT_LAUNCHES``, ``DRAW_LAUNCHES``) and, from inside the kernel,
in a device int64 per entry (``device_launches``: a graph's replays count
there).  The wrappers are lean: the ctypes functions, the stream getter
and the counts' addresses are bound once, and a call's outputs (keys,
values and the uniform's bits) are views of one ``torch.empty``.  On a
CPU key each function runs the plain version: the same arithmetic in
int64 tensor operations, each word masked to 32 bits after every add and
rotate, and the same float64 tensor operations after the draw.  A CUDA
key launches the kernel or raises.  Nothing reads back to the host.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
# threefry2x32's rotations (two sets, used in turn) and key-schedule parity
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# jax.random.normal's interval: (nextafter(-1, 0), 1), mapped from [0, 1)
_NORMAL_LO = float(np.nextafter(np.float64(-1.0), np.float64(0.0)))
_NORMAL_SCALE = float(np.float64(1.0) - np.float64(_NORMAL_LO))
_SQRT2 = float(np.sqrt(np.float64(2.0)))
# a draw's output: the uniforms, the normals, the two words of each
# counter (for the tests), or ``split_noise``'s values and keys from the
# chain key; the kernel's ``Mode``
_MODES = {"uniform": 0, "normal": 1, "bits": 2, "noise": 3}
# the draw entry's launch shape: threads a block, counters a thread
# (chip_smoke.py's [threefry sweep] on the card; PERF.md)
DRAW_PLAN = (128, 1)

# Launches of the threefry kernel's two entries by their wrappers on CUDA
# keys (never by the plain version): counted on the host when a wrapper runs
# (under a capture, once per captured launch) ...
SPLIT_LAUNCHES = 0
DRAW_LAUNCHES = 0
# ... and by the kernel itself, one int64 per entry and device that its
# thread 0 adds one to, so that a graph's replays count too
# (``device_launches``).
ENTRIES = ("split", "draw")
_DEVICE_COUNTS: dict = {}
# a card's counts' addresses, in ENTRIES order, and the bound entries
_COUNT_PTRS: dict = {}
_BOUND = None


def key(seed, device=None):
    """The chain's first key, JAX's ``PRNGKey(seed)`` words as an int64[2]
    tensor on ``device`` (the CPU for None)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([s >> 32, s & _MASK], dtype=torch.int64,
                        device=device)


def as_key(k, device):
    """A key given as a tensor, a numpy array or a JAX key (``uint32[2]``
    words) as the port's int64[2] tensor on ``device``."""
    if isinstance(k, torch.Tensor) and k.dtype == torch.int64:
        return k.to(device)
    words = np.asarray(k).astype(np.int64) & _MASK
    if words.shape != (2,):
        raise ValueError(f"a key is two 32-bit words, got shape "
                         f"{words.shape}")
    return torch.tensor(words, dtype=torch.int64, device=device)


def host_words(k):
    """A key's words as JAX's ``uint32[2]`` (what a checkpoint saves)."""
    return np.asarray(k.detach().cpu().numpy() & _MASK, dtype=np.uint32)


def _check(k):
    if not isinstance(k, torch.Tensor) or k.dtype != torch.int64 \
            or tuple(k.shape) != (2,):
        raise ValueError("a key is an int64[2] tensor (see _rng.key)")
    if k.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the noise stream runs on cpu or cuda, not "
                         f"{k.device}")


def split(k):
    """``(next key, draw key)``: one link of the chain."""
    if getattr(k, "is_cuda", False):
        return _split_cuda(k, None, uniform=False)
    _check(k)
    return split_reference(k)


def split_uniform(k, scale=None):
    """``(next key, draw key, uniform(draw key))`` in one call (one launch
    on the card); with ``scale`` (on the card a float64 0-d tensor on the
    key's device) the last is ``scale * uniform(draw key)``, rounded once
    as JAX's ``noise * jax.random.uniform(sub)``."""
    if getattr(k, "is_cuda", False):
        return _split_cuda(k, scale)
    _check(k)
    nxt, sub = split_reference(k)
    u = uniform_reference(sub)
    return nxt, sub, u if scale is None else scale * u


def split_noise(k, shape, shift=0.0, scale=1.0, base=None):
    """``(next key, draw key, base + (normal(draw key, shape) - shift) *
    scale)`` in one call (without ``base``: the noise alone), each
    operation rounded on its own, so the values are those of ``split``,
    ``normal`` and the three tensor operations bit for bit; one launch on
    the card.  ``shift`` and ``scale`` are numbers; ``base`` a float64
    tensor of ``shape`` on the key's device."""
    if getattr(k, "is_cuda", False):
        return _noise_cuda(k, shape, shift, scale, base)
    _check(k)
    return split_noise_reference(k, tuple(int(d) for d in shape), shift,
                                 scale, base)


def uniform(sub):
    """A float64 0-d tensor in [0, 1) from the draw key ``sub``:
    ``jax.random.uniform(sub, dtype=float64)``."""
    return _draw(sub, (), "uniform")


def normal(sub, shape):
    """Standard normal float64 samples of ``shape`` on ``sub``'s device
    from the draw key ``sub``: ``jax.random.normal(sub, shape, float64)``
    up to the last bits of ``erfinv``."""
    return _draw(sub, shape, "normal")


def bits(sub, shape):
    """The hash's two 32-bit words of each counter of ``shape`` (int64
    tensors ``(hi, lo)``): the 64-bit draws that ``uniform`` and ``normal``
    start from (``jax.random.bits(sub, shape, uint64)`` is
    ``hi << 32 | lo``)."""
    return _draw(sub, shape, "bits")


def _draw(sub, shape, mode):
    shape = tuple(int(d) for d in shape)
    if getattr(sub, "is_cuda", False):
        return _draw_cuda(sub, shape, mode)
    _check(sub)
    return _draw_reference(sub, shape, mode)


# ---- the plain version --------------------------------------------------------


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32_reference(k0, k1, x0, x1):
    """The threefry2x32 hash (20 rounds, JAX's ``_threefry2x32_lowering``)
    of the counter words ``(x0, x1)`` under the key words ``(k0, k1)``, all
    int64 tensors holding 32-bit words; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def split_reference(k):
    """The plain ``split``: the hash of the counters (0, 0) and (0, 1)."""
    hi, lo = threefry2x32_reference(
        k[0], k[1], torch.zeros(2, dtype=torch.int64, device=k.device),
        torch.arange(2, dtype=torch.int64, device=k.device))
    return torch.stack([hi[0], lo[0]]), torch.stack([hi[1], lo[1]])


def _counters(n, device):
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _MASK


def _unit(hi, lo):
    """[0, 1) from a 64-bit word: its top 52 bits over 2^52 (JAX's
    mantissa of 1.xxx minus 1, which is exact)."""
    mant = (hi << 20) | (lo >> 12)
    return mant.to(torch.float64) * 2.0 ** -52


def uniform_reference(sub):
    return _draw_reference(sub, (), "uniform")


def split_noise_reference(k, shape, shift, scale, base=None):
    """The plain ``split_noise``: ``split_reference``, the plain normal
    draw, and the tensor operations the unfused composition runs."""
    nxt, sub = split_reference(k)
    v = (_draw_reference(sub, shape, "normal") - shift) * scale
    return nxt, sub, v if base is None else base + v


def _draw_reference(sub, shape, mode):
    n = math.prod(shape)
    c_hi, c_lo = _counters(n, sub.device)
    hi, lo = threefry2x32_reference(sub[0], sub[1], c_hi, c_lo)
    if mode == "bits":
        return hi.reshape(shape), lo.reshape(shape)
    u = _unit(hi, lo)
    if mode == "normal":
        u = torch.clamp_min(u * _NORMAL_SCALE + _NORMAL_LO, _NORMAL_LO)
        u = _SQRT2 * torch.erfinv(u)
    return u.reshape(shape)


# ---- the kernel -----------------------------------------------------------------


def _device_count(device, entry):
    count = _DEVICE_COUNTS.get((entry, device.index))
    if count is None:
        count = torch.zeros((), dtype=torch.int64, device=device)
        _DEVICE_COUNTS[(entry, device.index)] = count
    return count


def _count_ptrs(index):
    """The addresses of the entries' device counts on card ``index``
    (``ENTRIES`` order), made at a card's first launch and kept."""
    ptrs = _COUNT_PTRS.get(index)
    if ptrs is None:
        dev = torch.device("cuda", index)
        ptrs = tuple(_device_count(dev, e).data_ptr() for e in ENTRIES)
        _COUNT_PTRS[index] = ptrs
    return ptrs


def device_launches(entry=None):
    """The launches of one entry (``"split"`` or ``"draw"``; both for None)
    the cards counted since the last reset (one read each)."""
    return sum(int(c) for (e, _), c in _DEVICE_COUNTS.items()
               if entry is None or e == entry)


def reset_device_launches():
    for c in _DEVICE_COUNTS.values():
        c.zero_()


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    from .ops import _build

    lib = _build.load("threefry")
    p, i, ll, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_double)
    lib.threefry_split_run.argtypes = [p, p, p, p, i, p]
    lib.threefry_split_run.restype = i
    lib.threefry_draw_run.argtypes = [p, ll, i, d, d, p, p, p, i, i, i, p]
    lib.threefry_draw_run.restype = i
    lib.threefry_error_string.argtypes = [i]
    lib.threefry_error_string.restype = ctypes.c_char_p
    return lib


def _bound():
    """The two entries' ctypes functions and the stream getter, bound at
    the first launch."""
    global _BOUND
    if _BOUND is None:
        lib = _kernel_lib()
        _BOUND = (lib.threefry_split_run, lib.threefry_draw_run,
                  torch._C._cuda_getCurrentRawStream)
    return _BOUND


def _raise(err, what):
    raise RuntimeError(f"threefry {what} failed: "
                       + _kernel_lib().threefry_error_string(err).decode())


def _card_key(k):
    """The key as the kernel takes it: int64[2], contiguous."""
    if k.dtype != torch.int64 or k.shape != (2,):
        _check(k)
    return k if k.is_contiguous() else k.contiguous()


def _split_cuda(k, scale, uniform=True):
    global SPLIT_LAUNCHES
    split_fn, _, stream = _bound()
    k = _card_key(k)
    index = k.get_device()
    scale_ptr = None
    if scale is not None:
        if not (isinstance(scale, torch.Tensor)
                and scale.dtype == torch.float64 and scale.numel() == 1
                and scale.get_device() == index):
            raise ValueError("on the card a split's scale is a float64 "
                             "0-d tensor on the key's device")
        scale_ptr = scale.data_ptr()
    # the two keys' words and the uniform's bits in one allocation
    out = k.new_empty(5)
    err = split_fn(k.data_ptr(), out.data_ptr(), scale_ptr,
                   _count_ptrs(index)[0], index, stream(index))
    if err:
        _raise(err, "split launch")
    SPLIT_LAUNCHES += 1
    nxt, sub, u = out.split((2, 2, 1))
    if not uniform:
        return nxt, sub
    return nxt, sub, u.view(torch.float64).view(())


def _draw_cuda(sub, shape, mode):
    global DRAW_LAUNCHES
    _, draw_fn, stream = _bound()
    sub = _card_key(sub)
    n = math.prod(shape)
    out = (sub.new_empty((2, n)) if mode == "bits"
           else sub.new_empty(n, dtype=torch.float64))
    if n:
        index = sub.get_device()
        err = draw_fn(sub.data_ptr(), n, _MODES[mode], 0.0, 1.0, None,
                      out.data_ptr(), _count_ptrs(index)[1], *DRAW_PLAN,
                      index, stream(index))
        if err:
            _raise(err, "draw launch")
        DRAW_LAUNCHES += 1
    if mode == "bits":
        return out[0].reshape(shape), out[1].reshape(shape)
    return out.reshape(shape)


def _noise_cuda(k, shape, shift, scale, base, plan=None):
    """``split_noise`` on the card: one launch of the draw entry in its
    noise mode, on the launch shape ``plan`` (``DRAW_PLAN`` for None)."""
    global DRAW_LAUNCHES
    _, draw_fn, stream = _bound()
    k = _card_key(k)
    index = k.get_device()
    n = math.prod(shape)
    base_ptr = None
    if base is not None:
        if base.dtype != torch.float64 or base.numel() != n \
                or base.get_device() != index:
            raise ValueError(f"a noise base is a float64 tensor of {n} "
                             "values on the key's device")
        if not base.is_contiguous():
            base = base.contiguous()
        base_ptr = base.data_ptr()
    # the two keys' words, then the values' bits, in one allocation
    out = k.new_empty(n + 4)
    threads, per_thread = DRAW_PLAN if plan is None else plan
    err = draw_fn(k.data_ptr(), n, _MODES["noise"], float(shift),
                  float(scale), base_ptr,
                  out.data_ptr(), _count_ptrs(index)[1], threads, per_thread,
                  index, stream(index))
    if err:
        _raise(err, "noise launch")
    DRAW_LAUNCHES += 1
    nxt, sub, vals = out.split((2, 2, n))
    vals = vals.view(torch.float64)
    return nxt, sub, vals if len(shape) == 1 else vals.view(shape)
