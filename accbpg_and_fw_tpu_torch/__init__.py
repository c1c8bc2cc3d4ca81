"""accbpg_and_fw_tpu_torch — the PyTorch/CUDA port of ``accbpg_and_fw_tpu``.

The JAX package stays the reference; this package keeps its public names,
arguments and return tuples so a script moves across by changing its
import.  Everything computes in ``torch.float64`` (Hopper has FP64 in
hardware, so the JAX package's double-single and int8-digit layers have no
counterpart here).  Functions take an explicit ``device=``: a numpy input
with ``device=None`` runs on the CPU, as torch's default does, and there is
no silent switch to CUDA.

Ported so far: the D-optimal-design Frank-Wolfe solvers and the lazy-H
block kernel that carries their large-problem path
(``ops/dopt_lazy.py`` + ``csrc/dopt_lazy.cu``).
"""

__version__ = "0.1.0"

from .algorithms import D_opt_FW, D_opt_FW_away

__all__ = ["D_opt_FW", "D_opt_FW_away"]
