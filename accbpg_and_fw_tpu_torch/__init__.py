"""accbpg_and_fw_tpu_torch — the PyTorch/CUDA port of ``accbpg_and_fw_tpu``.

The JAX package stays the reference; this package keeps its public names,
arguments and return tuples so a script moves across by changing its
import.  Everything computes in ``torch.float64`` (Hopper has FP64 in
hardware, so the JAX package's double-single and int8-digit layers have no
counterpart here).  Functions take an explicit ``device=``: a numpy input
with ``device=None`` runs on the CPU, as torch's default does, and there is
no silent switch to CUDA.

Ported so far:

* the D-optimal-design Frank-Wolfe solvers ``D_opt_FW`` and
  ``D_opt_FW_away``, with the lazy-H block kernel that carries their
  large-problem path (``ops/dopt_lazy.py`` + ``csrc/dopt_lazy.cu``) and
  the dense block kernel of ``u_mode="pallas"`` (``ops/dopt_dense.py`` +
  ``csrc/dopt_dense.cu``);
* the batched sweep entry point ``dopt_fw_batch`` (``parallel/``), over
  the batched exact engine and both kernels' batch entries;
* the Bregman proximal-gradient drivers ``BPG``, ``ABPG``, ``ABPG_expo``,
  ``ABPG_gain`` and ``ABDA`` (``algorithms/bpg.py``), with the oracle layer
  they need on D-optimal design (``ops/``: ``DOptimalObj``, the Burg
  h-oracles, the root finders) and the one-kernel Burg-simplex multiplier
  of ``BurgEntropySimplex(use_pallas=True)`` (``ops/simplex.py`` +
  ``csrc/simplex_mult.cu``);
* the factories ``D_opt_design`` and ``D_opt_KYinit`` (``apps/``).
"""

__version__ = "0.1.0"

from .algorithms import (ABDA, ABPG, BPG, ABPG_expo, ABPG_gain, D_opt_FW,
                         D_opt_FW_away, solve_theta)
from .apps import D_opt_design, D_opt_KYinit
from .ops import (BurgEntropy, BurgEntropyL1, BurgEntropyL2,
                  BurgEntropySimplex, DOptimalObj, LegendreFunction,
                  LegendreOracle, RSmoothFunction, SmoothOracle,
                  project_simplex_burg, simplex_inv_multiplier, solve_cubic)
from .parallel import dopt_fw_batch

__all__ = ["ABDA", "ABPG", "ABPG_expo", "ABPG_gain", "BPG",
           "BurgEntropy", "BurgEntropyL1", "BurgEntropyL2",
           "BurgEntropySimplex", "DOptimalObj", "D_opt_FW", "D_opt_FW_away",
           "D_opt_KYinit", "D_opt_design", "LegendreFunction",
           "LegendreOracle", "RSmoothFunction", "SmoothOracle",
           "dopt_fw_batch", "project_simplex_burg", "simplex_inv_multiplier",
           "solve_cubic", "solve_theta"]
