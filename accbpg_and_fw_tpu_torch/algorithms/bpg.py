"""Bregman proximal-gradient family: BPG, ABPG, ABPG_expo, ABPG_gain, ABDA.

Port of ``accbpg_and_fw_tpu/algorithms/bpg.py`` (HRX2018, arXiv:1808.03045;
reference: accbpg/algorithms.py:11-514): the same math, signatures, return
tuples and printed tables, for the plain steps (one oracle evaluation per
query, no carried Gram).

The plain steps (``_bpg_step``, ``_abpg_step``, ``_abpg_expo_step``,
``_abpg_gain_step``, ``_abda_step``) are JAX's device-scalar steps: the
carry is all tensors on the solve's device (``done`` a bool, ``L``,
``theta``, ``G``, ``sumlogG``, ``F_prev``, ``fx`` 0-d float64, ``kk``
int64), the problem's numbers are 0-d float64 tensors there too, and the
restart rules and the ``kk == 0`` branches are ``torch.where`` selects of
JAX's expressions in JAX's order.  The line searches are
``device_while`` loops with JAX's bound (``_LS_MAX``); so are theta's
Newton (``theta.solve_theta``) and the default simplex prox's
(``roots.simplex_inv_multiplier``).  On the card a chunk of them is a CUDA
graph (``driver.py``), a sharded run's too (its collectives captured
with it): the loops run as a fixed number of masked bodies
(``BPG_BODIES``, ``EXPO_BODIES``, ``GAIN_BODIES``), the host reads the
chunk's rows once, and an iteration whose loop needs more bodies runs
again eagerly.  Eagerly (the CPU, ``driver.eager_chunks``) each loop
reads its exit test once per turn.

Checkpoints use the JAX drivers' carry keys, history names and
fingerprints, so a run saved by either package resumes in the other.

Stochastic f-oracles get a fresh draw key per gradient evaluation from the
driver's ``seed``, where the JAX drivers split theirs (``_rng``: JAX's
chain of keys and its bits; the carry holds the key as a device tensor, so
a stochastic run's chunks are graphs too).

``fast_gram=True`` runs the JAX drivers' stateful linear-Gram steps
(``_*_dopt_step``) for an oracle with the fast-Gram protocol
(``DOptimalObj``): carried m x m Grams, a warm-started Schulz inverse and
trace-series logdet shifts (``fastgram.py``), one fresh Gram per trial, the
prox's multiplier carried as a warm start (``cpx``), and a recontraction
at every chunk boundary.  They are device-scalar steps in the plain steps'
form: their line searches are ``device_while`` loops with their own masked
bodies in a graph chunk (``FG_BPG_BODIES``, ``FG_EXPO_BODIES``,
``FG_GAIN_BODIES``), and their branch gates are device selects.
``fast_gram="ds"`` names the same FP64 engine (the JAX double-single engine
was a TPU workaround).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import _rng
from .._device import as_f64, full, replicate_like, resolve_device
from .._loops import device_while
from ..ops.base import vdot
from . import fastgram as _fg
from .driver import run_driver
from .theta import solve_theta

_LS_MAX = 200  # safety bound; backtracking terminates long before this

# Masked bodies of the plain steps' loops in a graph chunk: the line-search
# trials after the first (BPG, ABPG_gain) and the gamma trials (ABPG_expo).
# An iteration that needs more runs again eagerly (a continuation), and the
# rest of its chunk is replayed.  Chosen from the bodies the two paths of
# PERF.md took under ``eager_chunks`` on the card over 9000 iterations: BPG
# 30x1000 (default h) at most 6 bodies, more than 5 in 2 iterations;
# ABPG_gain 30x10000 a tail to 14, more than 6 in 10 iterations, all within
# the first 2000.  Fewer bodies cost more continuations than they save.
BPG_BODIES = 5
EXPO_BODIES = 4
GAIN_BODIES = 6
# The same for the fast_gram steps' line searches (``_*_dopt_step``): the
# trials after the first.  Chosen from the card's tally and walls
# (``chip_smoke.py --bodies``, PERF.md) over 9000 iterations under
# ``eager_chunks``: ABPG_gain 30x10000 took 0-4 in 99.5% (a tail to 14;
# as graphs 2 / 4 / 7 bodies 33.1 / 18.0 / 20.5 s for 2000 iterations);
# BPG-LS 30x1000 0-3 in 99.6% (3 / 4 bodies 9.6 / 7.3 s); ABPG_expo
# 30x1000 one in 4 iterations, never more.
FG_BPG_BODIES = 4
FG_EXPO_BODIES = 1
FG_GAIN_BODIES = 4
# Iterations a captured graph holds; a chunk replays it back to back.
GRAPH_SPAN = 32


def _keyed(f, x, key, value):
    """``(next key, f.value_and_grad(x, key=sub))`` (``f.grad`` where not
    ``value``) with ``(key, sub) = split(key)``: the oracle's keyed form
    where it has one (``FrobeniusSymLoss``: the split and the noisy
    gradient in one launch on the card), else the split and the keyed
    call."""
    keyed = getattr(f, "_value_and_grad_keyed" if value else "_grad_keyed",
                    None)
    if keyed is not None:
        return keyed(x, key)
    key, sub = _rng.split(key)
    return key, (f.value_and_grad if value else f.grad)(x, key=sub)


def _draw(cfg, c, f, x, value=True):
    """``(carry entries, f.value_and_grad(x))`` (``f.grad(x)`` where not
    ``value``) for one gradient evaluation: a stochastic f-oracle gets a
    fresh draw key split from the carry's (the JAX drivers' per-gradient
    split), and the next key comes back as ``{"key": ...}`` for the step's
    carry; an exact one gets none."""
    if getattr(cfg, "stochastic", False):
        key, out = _keyed(f, x, c["key"], value)
        return {"key": key}, out
    return {}, f.value_and_grad(x) if value else f.grad(x)


def _stoch_carry(f, carry, seed, fast_gram=False):
    """Add the noise key to the initial carry when the f-oracle is
    stochastic (``PRNGKey(seed)``'s words on x's device, seed None as 0);
    returns whether it is.  The fast-Gram steps never draw noise (the
    linear-Gram protocol oracles are exact), as in JAX."""
    stoch = bool(getattr(f, "stochastic", False)) and not fast_gram
    if stoch:
        carry["key"] = _rng.key(0 if seed is None else seed,
                                carry["x"].device)
    return stoch


def _trial_draw(cfg, f, x, key, value=True):
    """``(key, f.value_and_grad(x))`` (``f.grad(x)`` where not ``value``)
    for one line-search trial: a stochastic f-oracle gets a fresh draw key
    split from the trials' chain ``key`` (the JAX drivers split one per
    trial: each trial has its own point), an exact one none."""
    if cfg.stochastic:
        return _keyed(f, x, key, value)
    return key, f.value_and_grad(x) if value else f.grad(x)


def _start(f, x0):
    """x0 as float64 on the f-oracle's device (x0's own, or the CPU, for
    an oracle without one)."""
    return as_f64(x0, resolve_device(getattr(f, "device", None), like=x0))


def _num(like, v, dtype=torch.float64):
    """``v`` as a 0-d tensor on ``like``'s device (replicated on its mesh
    where ``like`` is a DTensor): a fill, so no copy from the host."""
    return replicate_like(torch.full((), v, dtype=dtype, device=like.device),
                          like)


def _scalars(like, **vals):
    """The JAX drivers' ``jnp.asarray(v, dt)`` of each number."""
    return {k: _num(like, float(v)) for k, v in vals.items()}


def _device_carry(x0, **vals):
    """A plain step's initial carry: ``done`` a bool tensor and the named
    numbers as 0-d float64 tensors (``kk`` int64), on x0's device."""
    carry = dict(done=_num(x0, False, torch.bool), x=x0)
    for k, v in vals.items():
        carry[k] = (_num(x0, 0, torch.int64) if k == "kk" else
                    v if isinstance(v, torch.Tensor) else _num(x0, v))
    return carry


def _with_cpx(state, cpx):
    """A trial's state with the prox's multiplier where it has one."""
    if cpx is not None:
        state["cpx"] = cpx
    return state


def _warm_prox(h, c, y, g, Lt):
    """div_prox_map with the carried multiplier warm start when the
    h-oracle has one (fast_gram carries hold ``cpx``); returns ``(x, new
    multiplier or None)``."""
    if "cpx" in c and hasattr(h, "div_prox_map_warm"):
        return h.div_prox_map_warm(y, g, Lt, c["cpx"])
    return h.div_prox_map(y, g, Lt), None


def _fast_start(f, h, x0, carry, with_z=True, warm="div_prox_map_warm"):
    """Add the fast-Gram state at ``x0`` to the initial carry (the JAX
    drivers' keys, 0-d tensors on x0's device: no read) and return the
    chunk-boundary refresh hook."""
    _fg.require_fast_gram(f)
    st = _fg.init_state(f, x0)
    carry.update(Gx=replicate_like(st["G0"], x0),
                 Minv=replicate_like(st["M0"], x0),
                 fx=replicate_like(-st["ld0"], x0))
    if with_z:
        carry["Gz"] = carry["Gx"]
    if hasattr(h, warm):
        carry["cpx"] = _num(x0, -float("inf"))
    return _dopt_state_refresh(f, with_z)


def _dopt_state_refresh(f, with_z=True):
    """``between_chunks`` hook: recontract the carried Grams, inverse and
    logdet from the exact iterates (``fastgram.refresh_state``), on the
    device with no read."""

    def refresh(carry, k_next):
        upd = _fg.refresh_state(f, carry["x"],
                                carry["z"] if with_z else carry["x"],
                                with_z=with_z)
        return {**carry, **{k: replicate_like(v, carry["x"])
                            for k, v in upd.items()}}

    return refresh


def _comb(theta, a, b):
    return (1.0 - theta) * a + theta * b


_GRAMS = ("Gx", "Gz", "Minv")


def _grams_carried(step):
    """A fast_gram step whose carry holds the m x m Grams and inverse as
    replicated DTensors where the solve is sharded (``_fast_start``), so
    that the driver's selects on the carry meet DTensors only, and whose
    body works on the plain tensors every rank holds (``f.gram`` sums a
    Gram over the mesh once): they go in as their local values and come
    out replicated again.  A replicated scalar that meets them enters as
    its local value too (``fastgram.comb``,
    ``fastgram.anchored_logdet_shift``, the restart's Gram select).  On
    one device both conversions leave the tensors as they are."""

    @functools.wraps(step)
    def run(cfg, prob, c, k):
        c2, hist = step(cfg, prob, {key: full(v) if key in _GRAMS else v
                                    for key, v in c.items()}, k)
        return {key: replicate_like(v, c2["x"]) if key in _GRAMS else v
                for key, v in c2.items()}, hist

    return run


def _plus(a, delta):
    """``a + delta`` for an allowance of ``_accept_delta``: an exact
    oracle's 0.0 adds no operation (and changes no bit but -0's)."""
    return a if isinstance(delta, float) and not delta else a + delta


def _accept_delta(f, scale):
    """Inexact-oracle allowance for descent acceptances:
    ``accept_tol * (1 + |scale|)`` for oracles that declare their noise,
    exactly 0.0 for exact ones (then adding it changes no bit)."""
    tol = getattr(f, "accept_tol", 0.0)
    if not tol:
        return 0.0
    return tol * (1.0 + abs(scale))


def _past_first(k, cond):
    """``(k > 0) & cond`` for ``k`` an int64 tensor (a graph chunk's) or a
    host int (an eager chunk's; a DTensor ``cond`` takes no Python bool)."""
    if isinstance(k, torch.Tensor):
        return (k > 0) & cond
    return cond if k > 0 else torch.zeros_like(cond)


def _restart_where(cfg, c, k, Fk, g, x_new, z_new, theta, kk, k_guard,
                   Gx_new=None, Gz_new=None):
    """JAX's ``_abpg_restart``: the function ('f') or gradient ('g')
    restart as ``torch.where`` selects; ``(theta, kk, z)`` after it, and
    ``Gz`` with it where the fast-Gram steps pass their Grams.
    ``k_guard`` keeps plain ABPG's explicit k > 0 gate (the others rely on
    F_prev starting at +inf)."""
    grams = Gz_new is not None
    if not cfg.restart:
        return (theta, kk, z_new) + ((Gz_new,) if grams else ())
    if cfg.restart_rule == 'f':
        trig = Fk > c["F_prev"]
    else:
        trig = vdot(g, x_new - c["x"]) > 0
    if k_guard:
        trig = _past_first(k, trig)
    out = (torch.where(trig, 1.0, theta), torch.where(trig, 0, kk),
           torch.where(trig, x_new, z_new))
    return out + ((torch.where(full(trig), Gx_new, Gz_new),) if grams
                  else ())


def _wants_gd(cfg):
    return cfg.restart and cfg.restart_rule != 'f'


def _printer(names):
    """The JAX drivers' progress row: k, the named values, the time."""
    fmt = "{0:6d}" + "".join(f"  {{{i + 1}:10.3e}}"
                             for i in range(len(names)))
    fmt += f"  {{{len(names) + 1}:6.1f}}"

    def row(k, r, t):
        print(fmt.format(k, *(r[n] for n in names), t))

    return row


def _run(step, cfg, prob, carry, maxitrs, title, columns, names, verbose,
         verbskip, chunk, checkpoint, between=None):
    header = f"\n{title}\n     k      F(x)  {columns}"
    return run_driver(step, carry, maxitrs, verbose=verbose,
                      verbskip=verbskip, header=header,
                      print_row=_printer(names), chunk=chunk,
                      checkpoint=checkpoint, between_chunks=between,
                      problem=prob, cfg=cfg, graph_span=GRAPH_SPAN)


# ---------------------------------------------------------------------------
# BPG
# ---------------------------------------------------------------------------


# The configs keep the JAX drivers' fields and defaults (gamma2 is never
# set here): their repr is the checkpoint fingerprint.
class _BPGCfg(NamedTuple):
    linesearch: bool
    stochastic: bool = False


def _bpg_step(cfg, prob, c, k):
    f, h = prob["f"], prob["h"]
    x, Lk = c["x"], c["L"]
    kc, (fx, g) = _draw(cfg, c, f, x)
    Fk = fx + h.extra_psi(x)
    stop = _past_first(k, torch.abs(Fk - c["F_prev"]) < prob["eps"])

    if cfg.linesearch:
        ls_ratio = prob["ls_ratio"]
        delta = _accept_delta(f, fx)

        def trial(Lt):
            x1 = h.div_prox_map(x, g, Lt)
            # NaN-robust acceptance: a trial that leaves the domain (NaN)
            # fails and L backs off
            fail = ~(f.value(x1) <= _plus(fx + vdot(g, x1 - x)
                                          + Lt * h.divergence(x1, x), delta))
            return Lt, x1, fail

        Lk, x_new, _ = device_while(lambda s: s[2],
                                    lambda s: trial(s[0] * ls_ratio),
                                    trial(Lk / ls_ratio), _LS_MAX, BPG_BODIES,
                                    "BPG trials")
    else:
        x_new = h.div_prox_map(x, g, Lk)

    return (dict(done=c["done"], x=x_new, L=Lk, F_prev=Fk, **kc),
            dict(F=Fk, Ls=Lk, _stop=stop))


@_grams_carried
def _bpg_dopt_step(cfg, prob, c, k):
    """BPG on a linear-Gram D-opt oracle (fast_gram=True): the gradient
    from a warm-started Schulz inverse of the carried Gram (the accepted
    trial of the previous iteration contracted it), and each line-search
    trial pays one fresh Gram and a trace-series logdet shift instead of
    an oracle value."""
    f, h = prob["f"], prob["h"]
    x, Lk, fx = c["x"], c["L"], c["fx"]
    ld_x = -fx
    M = _fg.inv_at(f, c["Gx"], c["Minv"])
    g = f.grad_from_inv(M)
    Fk = fx + h.extra_psi(x)
    stop = _past_first(k, torch.abs(Fk - c["F_prev"]) < prob["eps"])
    delta = _accept_delta(f, fx)

    def trial(Lt):
        x1, cpx = _warm_prox(h, c, x, g, Lt)
        G1 = f.gram(x1)
        ld1, s1 = _fg.anchored_logdet_shift(f, ld_x, 1.0, M, G1, G1)
        # acceptance on the logdet shift (f1 - fx = -s1): absolutely
        # accurate, immune to O(1) value cancellation (see fastgram)
        fail = ~(-s1 <= _plus(vdot(g, x1 - x) + Lt * h.divergence(x1, x),
                              delta))
        return _with_cpx(dict(L=Lt, x=x1, G=G1, fx=-ld1, fail=fail), cpx)

    if cfg.linesearch:
        ls_ratio = prob["ls_ratio"]
        s = device_while(lambda s: s["fail"],
                         lambda s: trial(s["L"] * ls_ratio),
                         trial(Lk / ls_ratio), _LS_MAX, FG_BPG_BODIES,
                         "BPG fast_gram trials")
        Lk = s["L"]
    else:
        s = trial(Lk)
    c2 = dict(done=c["done"], x=s["x"], L=Lk, F_prev=Fk, Gx=s["G"], Minv=M,
              fx=s["fx"])
    if "cpx" in c:
        c2["cpx"] = s["cpx"]
    return c2, dict(F=Fk, Ls=Lk, _stop=stop)


def BPG(f, h, L, x0, maxitrs, epsilon=1e-14, linesearch=True, ls_ratio=1.2,
        verbose=True, verbskip=1, chunk=None, checkpoint=None,
        fast_gram=False, seed=None):
    """Bregman Proximal Gradient method for min_{x in C} f(x) + Psi(x):

        x_{k+1} = argmin_{x in C} { Psi(x) + <f'(x_k), x> + L_k D_h(x, x_k) }

    with optional backtracking on the relative smoothness constant L
    (reference: algorithms.py:11-72).  Returns ``(x, F, Ls, T)``: ``x`` a
    float64 tensor on the f-oracle's device, the histories numpy arrays.
    ``seed`` seeds a stochastic f-oracle's noise (None as 0).

    ``fast_gram=True`` (or ``"ds"``): the stateful linear-Gram step for an
    oracle with the fast-Gram protocol (``DOptimalObj``): one Gram per
    line-search trial, a matmul-only inverse, trace-series logdets."""
    x0 = _start(f, x0)
    prob = dict(f=f, h=h, **_scalars(x0, eps=epsilon, ls_ratio=ls_ratio))
    carry = _device_carry(x0, L=L, F_prev=float("inf"))
    step, between = _bpg_step, None
    if fast_gram:
        between = _fast_start(f, h, x0, carry, with_z=False)
        step = _bpg_dopt_step
    cfg = _BPGCfg(linesearch=bool(linesearch),
                  stochastic=_stoch_carry(f, carry, seed, fast_gram))
    carry, hist, T = _run(step, cfg, prob, carry, maxitrs,
                          "BPG_LS method for min_{x in C} F(x) = f(x) + Psi(x)",
                          "       Lk       time", ["F", "Ls"], verbose,
                          verbskip, chunk, checkpoint, between)
    return carry["x"], hist["F"], hist["Ls"], T


# ---------------------------------------------------------------------------
# ABPG
# ---------------------------------------------------------------------------


class _ABPGCfg(NamedTuple):
    theta_eq: bool
    restart: bool
    restart_rule: str
    stochastic: bool = False
    gamma2: bool = False


def _abpg_theta(cfg, gam, c):
    """theta from the Newton equality (1 at kk == 0) or gamma/(kk + gamma),
    on the device."""
    kk = c["kk"]
    if cfg.theta_eq:
        return torch.where(kk > 0, solve_theta(c["theta"], gam), 1.0)
    return gam / (kk.to(torch.float64) + gam)


def _abpg_step(cfg, prob, c, k):
    f, h, L, gam = prob["f"], prob["h"], prob["L"], prob["gamma"]
    x, z = c["x"], c["z"]
    fx = f.value(x)
    Fk = fx + h.extra_psi(x)
    theta = _abpg_theta(cfg, gam, c)
    y = _comb(theta, x, z)
    kc, g = _draw(cfg, c, f, y, value=False)
    z_new = h.div_prox_map(z, g, theta ** (gam - 1.0) * L)
    x_new = _comb(theta, x, z_new)
    dxy, dzz = h.divergence(x_new, y), h.divergence(z_new, z)
    Gdr = dxy / dzz / theta ** gam
    theta_c, kk, z_new = _restart_where(cfg, c, k, Fk, g, x_new, z_new,
                                        theta, c["kk"] + 1, k_guard=True)
    return (dict(done=c["done"], x=x_new, z=z_new, theta=theta_c, kk=kk,
                 F_prev=Fk, **kc),
            dict(F=Fk, G=Gdr, theta=theta, dxy=dxy, dzz=dzz,
                 _stop=dzz < prob["eps"]))


@_grams_carried
def _abpg_dopt_step(cfg, prob, c, k):
    """Plain ABPG on a linear-Gram D-opt oracle (fast_gram=True): no
    oracle value at all: the gradient comes from the Schulz inverse of the
    combined Gram at y, and F advances through two trace-series logdet
    shifts anchored at the carried logdet G(x)."""
    f, h, L, gam = prob["f"], prob["h"], prob["L"], prob["gamma"]
    x, z, Gx, Gz = c["x"], c["z"], c["Gx"], c["Gz"]
    fx = c["fx"]
    ld_x = -fx
    Fk = fx + h.extra_psi(x)
    theta = _abpg_theta(cfg, gam, c)
    y = _comb(theta, x, z)
    Gy = _fg.comb(theta, Gx, Gz)
    M = _fg.inv_at(f, Gy, c["Minv"])
    g = f.grad_from_inv(M)
    z_new, cpx = _warm_prox(h, c, z, g, theta ** (gam - 1.0) * L)
    x_new = _comb(theta, x, z_new)
    Gz_new = f.gram(z_new)
    Gx_new = _fg.comb(theta, Gx, Gz_new)
    ld_y = _fg.anchored_logdet(f, ld_x, -1.0, M, Gx, Gy)
    ld_xn = _fg.anchored_logdet(f, ld_y, 1.0, M, Gx_new, Gx_new)
    dxy, dzz = h.divergence(x_new, y), h.divergence(z_new, z)
    Gdr = dxy / dzz / theta ** gam
    theta_c, kk, z_new, Gz_new = _restart_where(
        cfg, c, k, Fk, g, x_new, z_new, theta, c["kk"] + 1, k_guard=True,
        Gx_new=Gx_new, Gz_new=Gz_new)
    c2 = dict(done=c["done"], x=x_new, z=z_new, theta=theta_c, kk=kk,
              F_prev=Fk, Gx=Gx_new, Gz=Gz_new, Minv=M, fx=-ld_xn)
    if "cpx" in c:
        c2["cpx"] = cpx
    return c2, dict(F=Fk, G=Gdr, theta=theta, dxy=dxy, dzz=dzz,
                    _stop=dzz < prob["eps"])


def ABPG(f, h, L, x0, gamma, maxitrs, epsilon=1e-14, theta_eq=False,
         restart=False, restart_rule='g', verbose=True, verbskip=1,
         chunk=None, checkpoint=None, fast_gram=False, seed=None):
    """Accelerated Bregman Proximal Gradient (reference: algorithms.py:94-180).

    Triple-sequence update with TSE gamma; theta from gamma/(k+gamma) or the
    Newton equality; optional function ('f') / gradient ('g') restart.
    Returns ``(x, F, G, T)`` with G the triangle-scaling gains.
    ``fast_gram=True`` (or ``"ds"``): the stateful linear-Gram step (see
    ``BPG``), one fresh Gram per iteration."""
    x0 = _start(f, x0)
    prob = dict(f=f, h=h, **_scalars(x0, L=L, gamma=gamma, eps=epsilon))
    carry = _device_carry(x0, z=x0, theta=1.0, kk=0, F_prev=float("inf"))
    step, between = _abpg_step, None
    if fast_gram:
        between = _fast_start(f, h, x0, carry)
        step = _abpg_dopt_step
    cfg = _ABPGCfg(theta_eq=bool(theta_eq), restart=bool(restart),
                   restart_rule=str(restart_rule),
                   stochastic=_stoch_carry(f, carry, seed, fast_gram))
    carry, hist, T = _run(
        step, cfg, prob, carry, maxitrs,
        "ABPG method for minimize_{x in C} F(x) = f(x) + Psi(x)",
        "     theta        TSG       D(x+,y)     D(z+,z)     time",
        ["F", "theta", "G", "dxy", "dzz"], verbose, verbskip, chunk,
        checkpoint, between)
    return carry["x"], hist["F"], hist["G"], T


# ---------------------------------------------------------------------------
# ABPG_expo
# ---------------------------------------------------------------------------


class _ABPGExpoCfg(NamedTuple):
    theta_eq: bool
    checkdiv: bool
    restart: bool
    restart_rule: str
    stochastic: bool = False


def _abpg_expo_step(cfg, prob, c, k):
    f, h, L = prob["f"], prob["h"], prob["L"]
    delta, Gmargin = prob["delta"], prob["Gmargin"]
    x, z, kk, gamma = c["x"], c["z"], c["kk"], c["gamma"]
    # f(x) carried from the previous accepted trial (see _abpg_gain_step)
    fx = c["fx"]
    Fk = fx + h.extra_psi(x)
    theta = _abpg_theta(cfg, gamma, c)
    y = _comb(theta, x, z)
    kc, (fy, g) = _draw(cfg, c, f, y)

    def attempt(gm):
        z_new = h.div_prox_map(z, g, theta ** (gm - 1.0) * L)
        x_new = _comb(theta, x, z_new)
        dxy, dzz = h.divergence(x_new, y), h.divergence(z_new, z)
        Gdr = dxy / dzz / theta ** gm
        if cfg.checkdiv:
            fxn = torch.full_like(dzz, float("nan"))  # filled in after
            fail = ~(dxy <= Gmargin * theta ** gm * dzz)
        else:
            fxn = f.value(x_new)
            fail = ~(fxn <= _plus(fy + vdot(g, x_new - y)
                                  + theta ** gm * L * dzz,
                                  _accept_delta(f, fy)))
        return dict(gamma=gm, z=z_new, x=x_new, dxy=dxy, dzz=dzz, Gdr=Gdr,
                    fxn=fxn, fail=fail)

    s = device_while(lambda s: s["fail"] & (s["gamma"] > 1.0),
                     lambda s: attempt(torch.clamp_min(s["gamma"] - delta,
                                                       1.0)),
                     attempt(gamma), None, EXPO_BODIES, "ABPG_expo trials")
    gamma, z_new, x_new = s["gamma"], s["z"], s["x"]
    fx_new = f.value(x_new) if cfg.checkdiv else s["fxn"]
    theta_c, kk, z_new = _restart_where(cfg, c, k, Fk, g, x_new, z_new,
                                        theta, kk + 1, k_guard=False)
    return (dict(done=c["done"], x=x_new, z=z_new, theta=theta_c, kk=kk,
                 gamma=gamma, F_prev=Fk, fx=fx_new, **kc),
            dict(F=Fk, Gamma=gamma, G=s["Gdr"], theta=theta, dxy=s["dxy"],
                 dzz=s["dzz"], _stop=s["dzz"] < prob["eps"]))


@_grams_carried
def _abpg_expo_dopt_step(cfg, prob, c, k):
    """ABPG_expo on a linear-Gram D-opt oracle (fast_gram=True): the
    gradient from the combined-Gram Schulz inverse, and each
    gamma-adaption trial pays one fresh Gram and series logdets."""
    f, h, L = prob["f"], prob["h"], prob["L"]
    delta, Gmargin = prob["delta"], prob["Gmargin"]
    x, z, gamma, Gx, Gz = c["x"], c["z"], c["gamma"], c["Gx"], c["Gz"]
    fx = c["fx"]
    ld_x = -fx
    Fk = fx + h.extra_psi(x)
    theta = _abpg_theta(cfg, gamma, c)
    y = _comb(theta, x, z)
    Gy = _fg.comb(theta, Gx, Gz)
    M = _fg.inv_at(f, Gy, c["Minv"])
    ld_y = _fg.anchored_logdet(f, ld_x, -1.0, M, Gx, Gy)
    g = f.grad_from_inv(M)

    def attempt(gm):
        z_new, cpx = _warm_prox(h, c, z, g, theta ** (gm - 1.0) * L)
        x_new = _comb(theta, x, z_new)
        Gz_new = f.gram(z_new)
        Gx_new = _fg.comb(theta, Gx, Gz_new)
        ld_xn, s_xn = _fg.anchored_logdet_shift(f, ld_y, 1.0, M, Gx_new,
                                                Gx_new)
        dxy, dzz = h.divergence(x_new, y), h.divergence(z_new, z)
        Gdr = dxy / dzz / theta ** gm
        if cfg.checkdiv:
            fail = ~(dxy <= Gmargin * theta ** gm * dzz)
        else:
            # acceptance on the logdet shift (see fastgram)
            fail = ~(-s_xn <= _plus(vdot(g, x_new - y)
                                    + theta ** gm * L * dzz,
                                    _accept_delta(f, ld_x)))
        return _with_cpx(dict(gamma=gm, z=z_new, x=x_new, Gz=Gz_new,
                              Gx=Gx_new, fxn=-ld_xn, dxy=dxy, dzz=dzz,
                              Gdr=Gdr, fail=fail), cpx)

    s = device_while(lambda s: s["fail"] & (s["gamma"] > 1.0),
                     lambda s: attempt(torch.clamp_min(s["gamma"] - delta,
                                                       1.0)),
                     attempt(gamma), None, FG_EXPO_BODIES,
                     "ABPG_expo fast_gram trials")
    gamma, x_new, dzz = s["gamma"], s["x"], s["dzz"]
    theta_c, kk, z_new, Gz_new = _restart_where(
        cfg, c, k, Fk, g, x_new, s["z"], theta, c["kk"] + 1, k_guard=False,
        Gx_new=s["Gx"], Gz_new=s["Gz"])
    c2 = dict(done=c["done"], x=x_new, z=z_new, theta=theta_c, kk=kk,
              gamma=gamma, F_prev=Fk, Gx=s["Gx"], Gz=Gz_new, Minv=M,
              fx=s["fxn"])
    if "cpx" in c:
        c2["cpx"] = s["cpx"]
    return c2, dict(F=Fk, Gamma=gamma, G=s["Gdr"], theta=theta,
                    dxy=s["dxy"], dzz=dzz, _stop=dzz < prob["eps"])


def ABPG_expo(f, h, L, x0, gamma0, maxitrs, epsilon=1e-14, delta=0.2,
              theta_eq=True, checkdiv=False, Gmargin=10, restart=False,
              restart_rule='g', verbose=True, verbskip=1, chunk=None,
              checkpoint=None, fast_gram=False, seed=None):
    """ABPG with exponent adaption: start gamma0 > 2, decrease gamma by
    ``delta`` (floor 1) while the TSE inequality / descent condition fails
    (reference: algorithms.py:183-292).  Returns ``(x, F, Gamma, G, T)``.

    As in JAX, with ``restart=True, restart_rule='f'`` F_prev starts at
    +inf, so the k=0 comparison never restarts (the reference compares
    against an uninitialized history slot, algorithms.py:268).
    ``fast_gram=True`` (or ``"ds"``): the stateful linear-Gram step (see
    ``BPG``), one fresh Gram per gamma trial."""
    x0 = _start(f, x0)
    prob = dict(f=f, h=h, **_scalars(x0, L=L, eps=epsilon, delta=delta,
                                     Gmargin=Gmargin))
    carry = _device_carry(x0, z=x0, theta=1.0, kk=0, gamma=gamma0,
                          F_prev=float("inf"))
    step, between = _abpg_expo_step, None
    if fast_gram:
        between = _fast_start(f, h, x0, carry)
        step = _abpg_expo_dopt_step
    else:
        carry["fx"] = f.value(x0)
    cfg = _ABPGExpoCfg(theta_eq=bool(theta_eq), checkdiv=bool(checkdiv),
                       restart=bool(restart), restart_rule=str(restart_rule),
                       stochastic=_stoch_carry(f, carry, seed, fast_gram))
    carry, hist, T = _run(
        step, cfg, prob, carry, maxitrs,
        "ABPG_expo method for min_{x in C} F(x) = f(x) + Psi(x)",
        "     theta       gamma        TSG       D(x+,y)     D(z+,z)     "
        "time", ["F", "theta", "Gamma", "G", "dxy", "dzz"], verbose,
        verbskip, chunk, checkpoint, between)
    return carry["x"], hist["F"], hist["Gamma"], hist["G"], T


# ---------------------------------------------------------------------------
# ABPG_gain
# ---------------------------------------------------------------------------


class _ABPGGainCfg(NamedTuple):
    theta_eq: bool
    checkdiv: bool
    restart: bool
    restart_rule: str
    stochastic: bool = False
    gamma2: bool = False


def _abpg_gain_step(cfg, prob, c, k):
    f, h, L, gam = prob["f"], prob["h"], prob["L"], prob["gamma"]
    ls_inc, ls_dec, eps = prob["ls_inc"], prob["ls_dec"], prob["eps"]
    x, z, kk = c["x"], c["z"], c["kk"]
    G_1, theta_1 = c["G"], c["theta"]
    # f(x) was computed by the accepted trial of the PREVIOUS iteration
    # (the descent acceptance evaluates f(x_new)); the carry threads it
    # forward, initialized at f(x0)
    fx = c["fx"]
    Fk = fx + h.extra_psi(x)

    started, gam1 = kk > 0, gam - 1.0

    def attempt(G, key):
        if cfg.theta_eq:
            theta = torch.where(started, solve_theta(theta_1, gam, G / G_1),
                                theta_1)
        else:
            alpha = G / G_1
            theta = torch.where(
                started,
                theta_1 * ((1.0 + alpha * gam1) / (gam * alpha + theta_1)),
                theta_1)
        y = _comb(theta, x, z)
        # a stochastic oracle draws fresh noise per trial (each has its y)
        key, (fy, g) = _trial_draw(cfg, f, y, key)
        z_new = h.div_prox_map(z, g, theta ** gam1 * G * L)
        x_new = _comb(theta, x, z_new)
        dxy, dzz = h.divergence(x_new, y), h.divergence(z_new, z)
        early = dzz < eps
        Gdr = dxy / dzz / theta ** gam
        if cfg.checkdiv:
            fxn = torch.full_like(dzz, float("nan"))  # filled in after
            fail = ~(Gdr <= G)
        else:
            fxn = f.value(x_new)
            fail = ~(fxn <= _plus(fy + vdot(g, x_new - y)
                                  + theta ** gam * G * L * dzz,
                                  _accept_delta(f, fy)))
        s = dict(G=G, theta=theta, z=z_new, x=x_new, dxy=dxy, dzz=dzz,
                 Gdr=Gdr, fxn=fxn, fail=fail & ~early)
        if _wants_gd(cfg):  # the gradient restart's <g, x+ - x>
            s["g"] = g
        if cfg.stochastic:
            s["key"] = key
        return s

    s = device_while(lambda s: s["fail"],
                     lambda s: attempt(s["G"] * ls_inc, s.get("key")),
                     attempt(G_1 / ls_dec, c.get("key")), _LS_MAX,
                     GAIN_BODIES, "ABPG_gain trials")
    G, theta, x_new = s["G"], s["theta"], s["x"]
    fx_new = f.value(x_new) if cfg.checkdiv else s["fxn"]
    sumlogG = c["sumlogG"] + torch.log(G)
    Gavg = torch.exp(sumlogG / (gam + k))
    theta_c, kk, z_new = _restart_where(cfg, c, k, Fk, s.get("g"), x_new,
                                        s["z"], theta, kk + 1, k_guard=False)
    kc = {"key": s["key"]} if cfg.stochastic else {}
    return (dict(done=c["done"], x=x_new, z=z_new, theta=theta_c, kk=kk,
                 G=G, sumlogG=sumlogG, F_prev=Fk, fx=fx_new, **kc),
            dict(F=Fk, Gain=G, Gdiv=s["Gdr"], Gavg=Gavg, theta=theta,
                 dxy=s["dxy"], dzz=s["dzz"], _stop=s["dzz"] < eps))


@_grams_carried
def _abpg_gain_dopt_step(cfg, prob, c, k):
    """ABPG_gain on a linear-Gram D-opt oracle (fast_gram=True).

    G(x) = V diag(x) V^T is linear in x and the iterates y and x+ are
    convex combinations of carried points, so their Grams are m x m
    combinations of carried Grams: each line-search trial pays exactly one
    full O(m^2 n) contraction (the fresh prox output z+), a warm-started
    Schulz inverse instead of a factorization, and logdets advanced by the
    identity logdet G' = logdet G - logdet(M G) + logdet(M G') for
    M ~= G'^{-1}, each factor a trace series or the oracle's factorization
    (``fastgram``).  JAX's bound on the trials is folded into ``fail``
    (``t < _LS_MAX``), as there."""
    f, h, L, gam = prob["f"], prob["h"], prob["L"], prob["gamma"]
    ls_inc, ls_dec, eps = prob["ls_inc"], prob["ls_dec"], prob["eps"]
    x, z, Gx, Gz = c["x"], c["z"], c["Gx"], c["Gz"]
    G_1, theta_1 = c["G"], c["theta"]
    fx = c["fx"]
    ld_x = -fx
    Fk = fx + h.extra_psi(x)
    started = c["kk"] > 0

    def attempt(G, t):
        if cfg.theta_eq:
            theta = torch.where(started, solve_theta(theta_1, gam, G / G_1),
                                theta_1)
        else:
            alpha = G / G_1
            theta = torch.where(
                started,
                theta_1 * ((1.0 + alpha * (gam - 1.0))
                           / (gam * alpha + theta_1)),
                theta_1)
        y = _comb(theta, x, z)
        Gy = _fg.comb(theta, Gx, Gz)
        M = _fg.inv_at(f, Gy, c["Minv"])
        # logdet Gy = ld_x - logdet(M Gx)   [M ~= Gy^{-1}]
        ld_y = _fg.anchored_logdet(f, ld_x, -1.0, M, Gx, Gy)
        g = f.grad_from_inv(M)
        z_new, cpx = _warm_prox(h, c, z, g, theta ** (gam - 1.0) * G * L)
        x_new = _comb(theta, x, z_new)
        Gz_new = f.gram(z_new)
        Gx_new = _fg.comb(theta, Gx, Gz_new)
        # logdet Gx_new = ld_y + logdet(M Gx_new)
        ld_xn, s_xn = _fg.anchored_logdet_shift(f, ld_y, 1.0, M, Gx_new,
                                                Gx_new)
        dxy, dzz = h.divergence(x_new, y), h.divergence(z_new, z)
        early = dzz < eps
        Gdr = dxy / dzz / theta ** gam
        if cfg.checkdiv:
            fail = ~(Gdr <= G)
        else:
            # acceptance on the logdet shift (fxn - fy = -s_xn): immune to
            # O(1) value cancellation (see fastgram.anchored_logdet_shift)
            fail = ~(-s_xn <= _plus(vdot(g, x_new - y)
                                    + theta ** gam * G * L * dzz,
                                    _accept_delta(f, ld_x)))
        s = dict(G=G, theta=theta, z=z_new, x=x_new, Gz=Gz_new, Gx=Gx_new,
                 Minv=M, fxn=-ld_xn, dxy=dxy, dzz=dzz, Gdr=Gdr, t=t,
                 fail=fail & ~early & (t < _LS_MAX))
        if _wants_gd(cfg):  # the gradient restart's <g, x+ - x>
            s["g"] = g
        return _with_cpx(s, cpx)

    s = device_while(lambda s: s["fail"],
                     lambda s: attempt(s["G"] * ls_inc, s["t"] + 1),
                     attempt(G_1 / ls_dec, torch.zeros_like(c["kk"])), None,
                     FG_GAIN_BODIES, "ABPG_gain fast_gram trials")
    G, theta = s["G"], s["theta"]
    sumlogG = c["sumlogG"] + torch.log(G)
    Gavg = torch.exp(sumlogG / (gam + k))
    theta_c, kk, z_new, Gz_new = _restart_where(
        cfg, c, k, Fk, s.get("g"), s["x"], s["z"], theta, c["kk"] + 1,
        k_guard=False, Gx_new=s["Gx"], Gz_new=s["Gz"])
    c2 = dict(done=c["done"], x=s["x"], z=z_new, theta=theta_c, kk=kk,
              G=G, sumlogG=sumlogG, F_prev=Fk, fx=s["fxn"], Gx=s["Gx"],
              Gz=Gz_new, Minv=s["Minv"])
    if "cpx" in c:
        c2["cpx"] = s["cpx"]
    return c2, dict(F=Fk, Gain=G, Gdiv=s["Gdr"], Gavg=Gavg, theta=theta,
                    dxy=s["dxy"], dzz=s["dzz"], _stop=s["dzz"] < eps)


def ABPG_gain(f, h, L, x0, gamma, maxitrs, epsilon=1e-14, G0=1,
              ls_inc=1.2, ls_dec=1.2, theta_eq=True, checkdiv=False,
              restart=False, restart_rule='g', verbose=True, verbskip=1,
              chunk=None, checkpoint=None, fast_gram=False, seed=None):
    """ABPG with gain adaption ("ABPG-g"): per-iteration line search on the
    triangle-scaling gain G (optimistic divide by ls_dec, then multiply by
    ls_inc on failure), theta from solve_theta(theta_1, gamma, G/G_1) or the
    closed form (reference: algorithms.py:295-420).
    Returns ``(x, F, Gain, Gdiv, Gavg, T)``.

    As in JAX, with ``restart=True, restart_rule='f'`` F_prev starts at
    +inf, so the k=0 comparison never restarts (the reference compares
    against an uninitialized history slot, algorithms.py:404-405).

    ``fast_gram=True`` (or ``"ds"``): the stateful linear-Gram step for an
    oracle with the fast-Gram protocol (``DOptimalObj``): one fresh Gram
    per gain trial (see ``_abpg_gain_dopt_step``)."""
    x0 = _start(f, x0)
    prob = dict(f=f, h=h, **_scalars(x0, L=L, gamma=gamma, eps=epsilon,
                                     ls_inc=ls_inc, ls_dec=ls_dec))
    G0t = _num(x0, float(G0))
    carry = _device_carry(x0, z=x0, theta=1.0, kk=0, G=G0t,
                          sumlogG=prob["gamma"] * torch.log(G0t),
                          F_prev=float("inf"))
    step, between = _abpg_gain_step, None
    if fast_gram:
        between = _fast_start(f, h, x0, carry)
        step = _abpg_gain_dopt_step
    else:
        carry["fx"] = f.value(x0)
    cfg = _ABPGGainCfg(theta_eq=bool(theta_eq), checkdiv=bool(checkdiv),
                       restart=bool(restart), restart_rule=str(restart_rule),
                       stochastic=_stoch_carry(f, carry, seed, fast_gram))
    carry, hist, T = _run(
        step, cfg, prob, carry, maxitrs,
        "ABPG_gain method for min_{x in C} F(x) = f(x) + Psi(x)",
        "     theta         Gk         TSG       D(x+,y)     D(z+,z)      "
        "Gavg       time",
        ["F", "theta", "Gain", "Gdiv", "dxy", "dzz", "Gavg"], verbose,
        verbskip, chunk, checkpoint, between)
    return (carry["x"], hist["F"], hist["Gain"], hist["Gdiv"], hist["Gavg"],
            T)


# ---------------------------------------------------------------------------
# ABDA
# ---------------------------------------------------------------------------


class _ABDACfg(NamedTuple):
    theta_eq: bool
    stochastic: bool = False
    gamma2: bool = False


def _abda_step(cfg, prob, c, k):
    f, h, L, gam = prob["f"], prob["h"], prob["L"], prob["gamma"]
    x, z, kk = c["x"], c["z"], c["kk"]
    fx = f.value(x)
    Fk = fx + h.extra_psi(x)
    theta = _abpg_theta(cfg, gam, c)
    y = _comb(theta, x, z)
    kc, g = _draw(cfg, c, f, y, value=False)
    w = theta ** (1.0 - gam)
    gavg = c["gavg"] + w * g
    csum = c["csum"] + w
    z_new = h.prox_map(gavg / csum, L / csum)
    x_new = _comb(theta, x, z_new)
    dxy, dzz = h.divergence(x_new, y), h.divergence(z_new, z)
    Gdr = dxy / dzz / theta ** gam
    return (dict(done=c["done"], x=x_new, z=z_new, theta=theta, kk=kk + 1,
                 gavg=gavg, csum=csum, F_prev=Fk, **kc),
            dict(F=Fk, G=Gdr, theta=theta, dxy=dxy, dzz=dzz,
                 _stop=dzz < prob["eps"]))


@_grams_carried
def _abda_dopt_step(cfg, prob, c, k):
    """ABDA on a linear-Gram D-opt oracle (fast_gram=True): the gradient
    from the combined-Gram Schulz inverse, F through anchored trace-series
    logdet shifts (see fastgram)."""
    f, h, L, gam = prob["f"], prob["h"], prob["L"], prob["gamma"]
    x, z, Gx, Gz = c["x"], c["z"], c["Gx"], c["Gz"]
    fx = c["fx"]
    ld_x = -fx
    Fk = fx + h.extra_psi(x)
    theta = _abpg_theta(cfg, gam, c)
    y = _comb(theta, x, z)
    Gy = _fg.comb(theta, Gx, Gz)
    M = _fg.inv_at(f, Gy, c["Minv"])
    g = f.grad_from_inv(M)
    w = theta ** (1.0 - gam)
    gavg = c["gavg"] + w * g
    csum = c["csum"] + w
    if "cpx" in c and hasattr(h, "prox_map_warm"):
        z_new, cpx = h.prox_map_warm(gavg / csum, L / csum, c["cpx"])
    else:
        z_new, cpx = h.prox_map(gavg / csum, L / csum), None
    x_new = _comb(theta, x, z_new)
    Gz_new = f.gram(z_new)
    Gx_new = _fg.comb(theta, Gx, Gz_new)
    ld_y = _fg.anchored_logdet(f, ld_x, -1.0, M, Gx, Gy)
    ld_xn = _fg.anchored_logdet(f, ld_y, 1.0, M, Gx_new, Gx_new)
    dxy, dzz = h.divergence(x_new, y), h.divergence(z_new, z)
    Gdr = dxy / dzz / theta ** gam
    c2 = dict(done=c["done"], x=x_new, z=z_new, theta=theta, kk=c["kk"] + 1,
              gavg=gavg, csum=csum, F_prev=Fk, Gx=Gx_new, Gz=Gz_new, Minv=M,
              fx=-ld_xn)
    if "cpx" in c:
        c2["cpx"] = cpx
    return c2, dict(F=Fk, G=Gdr, theta=theta, dxy=dxy, dzz=dzz,
                    _stop=dzz < prob["eps"])


def ABDA(f, h, L, x0, gamma, maxitrs, epsilon=1e-14, theta_eq=True,
         verbose=True, verbskip=1, chunk=None, checkpoint=None,
         fast_gram=False, seed=None):
    """Accelerated Bregman Dual Averaging: accumulates the weighted gradient
    average and uses the *primal* prox_map (reference: algorithms.py:423-514;
    restart is intentionally unsupported, :445-446).
    Returns ``(x, F, G, T)``.  ``fast_gram=True`` (or ``"ds"``): the
    stateful linear-Gram step (see ``BPG``)."""
    x0 = _start(f, x0)
    prob = dict(f=f, h=h, **_scalars(x0, L=L, gamma=gamma, eps=epsilon))
    carry = _device_carry(x0, z=x0, theta=1.0, kk=0,
                          gavg=torch.zeros_like(x0), csum=0.0,
                          F_prev=float("inf"))
    step, between = _abda_step, None
    if fast_gram:
        between = _fast_start(f, h, x0, carry, warm="prox_map_warm")
        step = _abda_dopt_step
    cfg = _ABDACfg(theta_eq=bool(theta_eq),
                   stochastic=_stoch_carry(f, carry, seed, fast_gram))
    carry, hist, T = _run(
        step, cfg, prob, carry, maxitrs,
        "ABDA method for min_{x in C} F(x) = f(x) + Psi(x)",
        "     theta        TSG       D(x+,y)     D(z+,z)     time",
        ["F", "theta", "G", "dxy", "dzz"], verbose, verbskip, chunk,
        checkpoint, between)
    return carry["x"], hist["F"], hist["G"], T
