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
* the Kumar-Yildirim start ``D_opt_KYinit`` (``apps/``).
"""

__version__ = "0.1.0"

from .algorithms import D_opt_FW, D_opt_FW_away
from .apps import D_opt_KYinit
from .parallel import dopt_fw_batch

__all__ = ["D_opt_FW", "D_opt_FW_away", "D_opt_KYinit", "dopt_fw_batch"]
