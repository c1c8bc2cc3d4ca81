"""Relatively-smooth f-oracles of the port: D-optimal design.

Port of ``accbpg_and_fw_tpu/ops/f_oracles.py:33-108`` (reference:
functions.py:27-82).  The JAX package's fast-Gram protocol (``gram``,
``logdet_full``, ``inv_seed``, ``grad_from_inv``) belongs to the
``fast_gram`` drivers and is not ported yet, nor are the other f-oracles.
"""

from __future__ import annotations

import torch

from .._device import as_f64, resolve_device
from .base import SmoothOracle


class DOptimalObj(SmoothOracle):
    """f(x) = -log det(H diag(x) H^T), H is m-by-n with m < n.

    One Cholesky factorization of ``H diag(x) H^T`` serves the log-det and
    the gradient ``g_i = -||R^{-1} h_i||^2`` (one triangular solve).  A
    matrix that is not positive definite gives NaN, as JAX's Cholesky does
    (``cholesky_ex``, so no host sync on CUDA).  ``H`` is held as a float64
    tensor on ``device`` (a tensor's own device for None, else the CPU).

    ``n_valid``: when set, gradient entries past it report +1e30 instead
    of the 0 a zero-padded column gives, so every Burg/simplex prox sends
    padded coordinates to ~1e-30 mass.
    """

    def __init__(self, H, n_valid=None, device=None):
        self.H = as_f64(H, resolve_device(device, like=H))
        self.n_valid = None if n_valid is None else int(n_valid)

    @property
    def device(self):
        return self.H.device

    def _mask_pads(self, g):
        if self.n_valid is None:
            return g
        lane = torch.arange(g.shape[-1], device=g.device)
        return torch.where(lane < self.n_valid, g, 1e30)

    def _chol(self, x):
        HXHT = (self.H * x) @ self.H.T
        R, info = torch.linalg.cholesky_ex(HXHT)
        return R, info == 0

    def value(self, x, key=None):
        R, ok = self._chol(x)
        f = -2.0 * torch.sum(torch.log(torch.diagonal(R)))
        return torch.where(ok, f, torch.nan)

    def value_and_grad(self, x, key=None):
        R, ok = self._chol(x)  # lower triangular, HXHT = R R^T
        f = -2.0 * torch.sum(torch.log(torch.diagonal(R)))
        # g_i = -h_i^T (HXHT)^{-1} h_i = -||R^{-1} h_i||^2
        W = torch.linalg.solve_triangular(R, self.H, upper=False)
        g = -torch.sum(W * W, dim=0)
        return (torch.where(ok, f, torch.nan),
                self._mask_pads(torch.where(ok, g, torch.nan)))
