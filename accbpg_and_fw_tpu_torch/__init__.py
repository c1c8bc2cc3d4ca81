"""accbpg_and_fw_tpu_torch — the PyTorch/CUDA port of ``accbpg_and_fw_tpu``.

The JAX package stays the reference; this package keeps its public names,
arguments and return tuples so a script moves across by changing its
import.  Everything computes in ``torch.float64`` (Hopper has FP64 in
hardware, so the JAX package's double-single and int8-digit layers have no
counterpart here: their ``*Mixed``/``*DS`` names resolve to the FP64
classes).  The entry points run on the card unless the caller asks for
the CPU: with ``device=None`` a tensor input keeps its device and a numpy
input goes to CUDA, ``device="cpu"`` asks for the CPU, and without a card
the default raises instead of falling back.

Ported so far:

* the D-optimal-design Frank-Wolfe solvers ``D_opt_FW`` and
  ``D_opt_FW_away``, with the lazy-H block kernel that carries their
  large-problem path (``ops/dopt_lazy.py`` + ``csrc/dopt_lazy.cu``) and
  the dense block kernel of ``u_mode="pallas"`` (``ops/dopt_dense.py`` +
  ``csrc/dopt_dense.cu``);
* the batched sweep entry point ``dopt_fw_batch`` (``parallel/``), over
  the batched exact engine and both kernels' batch entries;
* the Bregman proximal-gradient drivers ``BPG``, ``ABPG``, ``ABPG_expo``,
  ``ABPG_gain`` and ``ABDA`` (``algorithms/bpg.py``), with the one-kernel
  Burg-simplex multiplier of ``BurgEntropySimplex(use_pallas=True)``
  (``ops/simplex.py`` + ``csrc/simplex_mult.cu``);
* the Frank-Wolfe family ``FW_alg_div_step``, ``FW_alg_descent_step``,
  ``FW_alg_L0_L1_shortest_step``, ``FW_l0l1_log_and_linear_step`` and
  ``FW_l0l1_log_only`` (``algorithms/fw.py``) with the seven LMOs
  (``ops/lmo.py``), plain PyTorch as the JAX path was plain XLA;
* the inexact-oracle and constrained drivers ``AIBM``, ``AdaptFGM``,
  ``UniversalGM`` and ``PrimalDualSwitchingGradientMethod``
  (``algorithms/extras.py``), and the stochastic-oracle protocol: noise
  drawn from a chain of keys seeded by each driver's ``seed``
  (``_rng.py``);
* the oracles (``ops/``): every h-oracle, the f-oracles ``DOptimalObj``,
  ``PoissonRegression``, ``KLdivRegression``, ``SVM_fun``,
  ``FrobeniusSymLoss``, ``LogisticRegression`` and ``AX_b``, and
  ``calculate_tse_constant``;
* the factories (``apps/``) of D-optimal design (random and LIBSVM), the
  Poisson/KL regressions, the SVM ball, SymNMF (with and without linear
  constraints) and the (L0,L1) logistic problems (synthetic and a9a),
  with the numpy helpers and the LIBSVM loader they call.

Not ported yet: ``fast_gram``, sharding (``parallel/mesh.py``) and
``diagnostics.py``.
"""

__version__ = "0.1.0"

from .algorithms import (AIBM, ABDA, ABPG, BPG, ABPG_expo, ABPG_gain,
                         AdaptFGM, D_opt_FW, D_opt_FW_away,
                         FW_alg_descent_step, FW_alg_div_step,
                         FW_alg_L0_L1_shortest_step,
                         FW_l0l1_log_and_linear_step, FW_l0l1_log_only,
                         PrimalDualSwitchingGradientMethod, UniversalGM,
                         solve_theta)
from .apps import *  # noqa: F401,F403
from .apps import __all__ as _apps_all
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from .parallel import dopt_fw_batch

__all__ = sorted(set(_apps_all) | set(_ops_all) | {
    "ABDA", "ABPG", "ABPG_expo", "ABPG_gain", "AIBM", "AdaptFGM", "BPG",
    "D_opt_FW", "D_opt_FW_away", "FW_alg_L0_L1_shortest_step",
    "FW_alg_descent_step", "FW_alg_div_step", "FW_l0l1_log_and_linear_step",
    "FW_l0l1_log_only", "PrimalDualSwitchingGradientMethod", "UniversalGM",
    "dopt_fw_batch", "solve_theta"})
