"""Operator layer of the port (counterpart of ``accbpg_and_fw_tpu/ops``):
the oracle interfaces, the Burg h-oracles, the D-optimal design f-oracle,
the root finders, the one-kernel simplex multiplier and the D-opt engines'
kernels."""

from .base import (LegendreFunction, LegendreOracle, RSmoothFunction,
                   SmoothOracle)
from .f_oracles import DOptimalObj
from .h_oracles import (BurgEntropy, BurgEntropyL1, BurgEntropyL2,
                        BurgEntropySimplex)
from .roots import (bisect_monotone, newton_scalar, project_simplex_burg,
                    simplex_inv_multiplier, solve_cubic)
from .simplex import simplex_inv_multiplier_pallas

__all__ = ["BurgEntropy", "BurgEntropyL1", "BurgEntropyL2",
           "BurgEntropySimplex", "DOptimalObj", "LegendreFunction",
           "LegendreOracle", "RSmoothFunction", "SmoothOracle",
           "bisect_monotone", "newton_scalar", "project_simplex_burg",
           "simplex_inv_multiplier", "simplex_inv_multiplier_pallas",
           "solve_cubic"]
