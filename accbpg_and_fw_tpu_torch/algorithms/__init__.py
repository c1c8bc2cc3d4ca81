"""Algorithm drivers of the port (counterpart of
``accbpg_and_fw_tpu/algorithms``)."""

from .d_opt import D_opt_FW, D_opt_FW_away
from .driver import run_driver

__all__ = ["D_opt_FW", "D_opt_FW_away", "run_driver"]
