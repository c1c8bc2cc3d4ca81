"""Hand problems and solver state over from the JAX package to the port.

``from_jax_oracle`` turns a JAX f- or h-oracle into the port's, so both
packages compute the same thing.  ``from_jax_carry`` turns the JAX
package's D-opt state, given as numpy arrays or as a block-engine
checkpoint file, into the port's FP64 tensors; ``continue_dopt`` runs the
port's exact engine on from there, so a run started under JAX finishes
here.  (Checkpoint files need no conversion: the port's drivers read the
JAX ``.npz`` formats and fingerprints directly.)
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ._device import as_f64, resolve_device
from .algorithms.d_opt import _dopt_factorize, _run_exact
from .ops import f_oracles, h_oracles
from .ops.dopt_common import _CKPT_VERSION
from .ops.f_oracles import DOptimalObj

_DS_NAMES = (("x", "x"), ("w", "w"), ("H", "H"), ("logdet", "ld"))


# h-oracles: the port's class and the scalar fields read off the JAX one
# (every JAX field of these classes is a number or None; ``center`` may be
# an array)
_H_FIELDS = {
    "BurgEntropy": (), "BurgEntropyL1": ("lamda",),
    "BurgEntropyL2": ("lamda",),
    "BurgEntropyL2Ball": ("lamda", "radius", "center", "delta"),
    "BurgEntropySimplex": ("eps",), "ShannonEntropy": ("delta",),
    "ShannonEntropyL1": ("delta", "lamda"),
    "ShannonEntropySimplex": ("delta",),
    "SumOf2nd4thPowers": ("alpha", "sigma"),
    "SumOf2nd4thPowersPositiveOrthant": ("alpha", "sigma", "upper_bound"),
    "SumOf2nd4thPowersPositiveOrthantDS": ("alpha", "sigma", "upper_bound"),
    "SumOf2nd4thPowersOnSimplex": ("alpha", "sigma", "radius", "eps"),
    "SumOf2nd4thPowersDualProxMap": ("alpha", "sigma", "num_iters",
                                     "eta_base", "tolerance", "radius"),
    "SquaredL2Norm": (), "PowerNeg1": (), "L2L1Linf": ("lamda", "B"),
    "PolyDiv": ("DS_mean", "DS_mean_quad", "lamda", "radius"),
}

# f-oracles: the port's class and the JAX fields passed to its constructor
_F_FIELDS = {
    "PoissonRegression": ("A", "b"), "KLdivRegression": ("A", "b"),
    "SVM_fun": ("lamda", "A", "y"), "LogisticRegression": ("X", "y", "alpha"),
    "FrobeniusSymLoss": ("M", "M_norm", "noise_level"),
    "AX_b": ("A", "b"),
}


def _field(obj, name):
    v = getattr(obj, name)
    if v is None:
        return None
    a = np.asarray(v, np.float64)
    return float(a) if a.ndim == 0 else a


def from_jax_oracle(obj, device=None):
    """The port's counterpart of the JAX oracle ``obj``, read through its
    fields (this module does not import JAX):

    * f-oracles: ``DOptimalObj`` (``H``, ``n_valid``), ``PoissonRegression``
      and ``KLdivRegression`` (``A``, ``b``), ``SVM_fun`` (``lamda``,
      ``A``, ``y``), ``LogisticRegression`` (``X``, ``y``, ``alpha``),
      ``FrobeniusSymLoss`` (``M``, ``M_norm``, ``noise_level``) and
      ``AX_b`` (``A``, ``b``), with their data as float64 on ``device``
      (CUDA for None);
    * every h-oracle the port has, with its scalar fields (``lamda``,
      ``eps``, ``delta``, ``alpha``, ``sigma``, ``upper_bound``,
      ``radius``, ``center``, ``B``, ``DS_mean``, ``DS_mean_quad``,
      ``num_iters``, ``eta_base``, ``tolerance``) and
      ``BurgEntropySimplex``'s ``use_pallas``;
      ``SumOf2nd4thPowersPositiveOrthantDS`` gives the FP64 class.

    Raises ``TypeError`` for ``SumOf2nd4thPowersWithFrankWolfe`` (its LMO
    is a JAX closure, which cannot be read back: build the port's with a
    port LMO) and for the oracles the port has not ported, the JAX
    ``*Mixed``/``*DS`` f-oracles among them (their data are digit planes:
    convert the plain oracle of the same data instead)."""
    name = type(obj).__name__
    if name == "DOptimalObj":
        return DOptimalObj(np.asarray(obj.H, np.float64),
                           n_valid=(None if obj.n_valid is None
                                    else int(np.asarray(obj.n_valid))),
                           device=resolve_device(device))
    if name in _F_FIELDS:
        kw = {k: _field(obj, k) for k in _F_FIELDS[name]}
        return getattr(f_oracles, name)(**kw, device=resolve_device(device))
    if name == "SumOf2nd4thPowersWithFrankWolfe":
        raise TypeError(f"{name} carries a JAX LMO closure, which cannot be "
                        "read back; build the port's with a port LMO")
    if name in _H_FIELDS:
        kw = {k: _field(obj, k) for k in _H_FIELDS[name]}
        if name == "BurgEntropySimplex":
            kw["use_pallas"] = bool(obj.use_pallas)
        return getattr(h_oracles, name)(**kw)
    raise TypeError(f"no port of the oracle {name} yet")


def from_jax_carry(carry, device=None):
    """The port's D-opt state from a JAX one.

    ``carry`` is one of:

    * the exact engine's carry ``{x, w, H, logdet}`` (``done`` optional);
    * the double-single engine's carry ``{x_hi, x_lo, w_hi, w_lo, H_hi,
      H_lo, ld_hi, ld_lo}``, each pair summed in f64;
    * the path of a checkpoint written by ``dopt_fw_pallas_lazy`` or
      ``dopt_fw_pallas`` (or by the port's ``dopt_fw_lazy`` or
      ``dopt_fw_dense``: the same file), whose state is the iterate alone:
      the result is ``{x, k}`` with ``k`` the iterations done
      (``continue_dopt`` refactorizes from ``x``).

    Returns a dict of float64 tensors on ``device`` (CUDA for None) with
    keys ``done, x, w, H, logdet`` (or ``x, k`` for a checkpoint path).
    """
    dev = resolve_device(device)
    if isinstance(carry, (str, os.PathLike)):
        with np.load(carry) as z:
            if (int(z["__v"]) != _CKPT_VERSION or "x" not in z.files
                    or not str(z["__fp"]).startswith("dopt_fw_pallas")):
                raise ValueError(f"{carry!r} is not a block-engine "
                                 "checkpoint")
            return dict(x=as_f64(z["x"], dev), k=int(z["__k"]))
    if "x_hi" in carry:
        out = {name: as_f64(np.asarray(carry[f"{src}_hi"], np.float64)
                            + np.asarray(carry[f"{src}_lo"], np.float64), dev)
               for name, src in _DS_NAMES}
    elif {"x", "w", "H", "logdet"} <= set(carry):
        out = {name: as_f64(carry[name], dev)
               for name in ("x", "w", "H", "logdet")}
    else:
        raise ValueError(f"unrecognised D-opt carry keys {sorted(carry)}")
    out["done"] = torch.tensor(bool(np.asarray(carry.get("done", False))),
                               device=dev)
    return out


def continue_dopt(V, state, eps, maxitrs, *, away=True, k_start=0,
                  verbose=False, verbskip=1, chunk=None, refresh_every=0,
                  device=None):
    """Run the port's exact engine from ``state`` (``from_jax_carry``'s
    result) for iterations ``k_start <= k < maxitrs``; returns ``(x, F, SP,
    SN, T)`` for those iterations.  A state without ``H`` (a lazy-engine
    checkpoint) is refactorized from its iterate first."""
    dev = resolve_device(device, like=V)
    V = as_f64(V, dev)
    x = state["x"].to(dev)
    if "H" in state:
        carry = dict(done=state["done"].to(dev), x=x, w=state["w"].to(dev),
                     H=state["H"].to(dev), logdet=state["logdet"].to(dev))
    else:
        H, w, logdet = _dopt_factorize(V, x)
        carry = dict(done=torch.tensor(False, device=dev), x=x, w=w, H=H,
                     logdet=logdet)
    return _run_exact(V, carry, eps, maxitrs, away=away, verbose=verbose,
                      verbskip=verbskip, chunk=chunk,
                      refresh_every=refresh_every, header=None,
                      checkpoint=None, k_start=k_start)
