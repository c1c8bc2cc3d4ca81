"""Algorithm drivers of the port (counterpart of
``accbpg_and_fw_tpu/algorithms``)."""

from .bpg import ABDA, ABPG, BPG, ABPG_expo, ABPG_gain
from .d_opt import D_opt_FW, D_opt_FW_away
from .driver import run_driver
from .theta import solve_theta

__all__ = ["ABDA", "ABPG", "ABPG_expo", "ABPG_gain", "BPG", "D_opt_FW",
           "D_opt_FW_away", "run_driver", "solve_theta"]
