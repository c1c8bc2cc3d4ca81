"""Algorithm drivers of the port (counterpart of
``accbpg_and_fw_tpu/algorithms``)."""

from .bpg import ABDA, ABPG, BPG, ABPG_expo, ABPG_gain
from .d_opt import D_opt_FW, D_opt_FW_away
from .driver import run_driver, scan_full
from .extras import (AIBM, AdaptFGM, PrimalDualSwitchingGradientMethod,
                     UniversalGM)
from .fw import (FW_alg_descent_step, FW_alg_div_step,
                 FW_alg_L0_L1_shortest_step, FW_l0l1_log_and_linear_step,
                 FW_l0l1_log_only)
from .theta import solve_theta
from .._device import solver_device

__all__ = ["ABDA", "ABPG", "ABPG_expo", "ABPG_gain", "AIBM", "AdaptFGM",
           "BPG", "D_opt_FW", "D_opt_FW_away", "FW_alg_L0_L1_shortest_step",
           "FW_alg_descent_step", "FW_alg_div_step",
           "FW_l0l1_log_and_linear_step", "FW_l0l1_log_only",
           "PrimalDualSwitchingGradientMethod", "UniversalGM", "run_driver",
           "scan_full", "solve_theta", "solver_device"]
