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

Everything of the JAX package is ported:

* the D-optimal-design Frank-Wolfe solvers ``D_opt_FW`` and
  ``D_opt_FW_away``, with the lazy-H block kernel that carries their
  large-problem path (``ops/dopt_lazy.py`` + ``csrc/dopt_lazy.cu``) and
  the dense block kernel of ``u_mode="pallas"`` (``ops/dopt_dense.py`` +
  ``csrc/dopt_dense.cu``);
* the Bregman proximal-gradient drivers ``BPG``, ``ABPG``, ``ABPG_expo``,
  ``ABPG_gain`` and ``ABDA`` (``algorithms/bpg.py``), with their
  ``fast_gram`` linear-Gram steps (``algorithms/fastgram.py``) and the
  one-kernel Burg-simplex multiplier of
  ``BurgEntropySimplex(use_pallas=True)`` (``ops/simplex.py`` +
  ``csrc/simplex_mult.cu``);
* the Frank-Wolfe family ``FW_alg_div_step``, ``FW_alg_descent_step``,
  ``FW_alg_L0_L1_shortest_step``, ``FW_l0l1_log_and_linear_step`` and
  ``FW_l0l1_log_only`` (``algorithms/fw.py``) with the seven LMOs
  (``ops/lmo.py``);
* the inexact-oracle and constrained drivers ``AIBM``, ``AdaptFGM``,
  ``UniversalGM`` and ``PrimalDualSwitchingGradientMethod``
  (``algorithms/extras.py``), and the stochastic-oracle protocol
  (``_rng.py``: JAX's threefry key chain, on the card in
  ``csrc/threefry.cu``);
* the oracles (``ops/``), the problem factories and utilities
  (``apps/``), and the JAX package's public digit contractions
  (``ops/mixed_precision.py``, which no solver here uses);
* batching and sharding (``parallel/``): ``vmap_solver``,
  ``dopt_fw_batch`` over the batched exact engine and both kernels' batch
  entries, and ``parallel/mesh.py``'s process groups, device meshes and
  problem sharding on ``torch.distributed`` (one rank per device);
* ``diagnostics`` (debug mode, domain checks, profiler traces), ``viz``
  (comparison plots, triangle-scaling curves), checkpoints in the JAX
  drivers' format, ``run_driver`` (JAX's cached step form; on the card a
  chunk that reads nothing back is a cached CUDA graph), ``scan_full``
  and ``solver_device``.

Not ported, on purpose: the double-single and int8 engines behind the
JAX package's TPU precision modes (their names resolve to FP64 here), the
disk half of its AOT executable cache (a graph lives in the process that
captured it), its automatic CPU fallback for small problems and its
one-process mesh over many devices.
"""

__version__ = "0.1.0"

from . import diagnostics, parallel  # noqa: F401  (submodule access)
from .algorithms import *  # noqa: F401,F403  (iteration drivers)
from .algorithms import __all__ as _alg_all
from .apps import *  # noqa: F401,F403  (problem factories + utils)
from .apps import __all__ as _apps_all
from .ops import *  # noqa: F401,F403  (oracle layer: f/h oracles + LMOs)
from .ops import __all__ as _ops_all
from .parallel import dopt_fw_batch
from .viz import *  # noqa: F401,F403  (plot_comparisons, plotTSE)
from .viz import __all__ as _viz_all

__all__ = sorted(set(_alg_all) | set(_apps_all) | set(_ops_all)
                 | set(_viz_all) | {"dopt_fw_batch"})
