"""Operator layer of the port (counterpart of ``accbpg_and_fw_tpu/ops``):
the oracle interfaces, the h- and f-oracles, the LMOs, the root finders,
the one-kernel simplex multiplier, the D-opt engines' kernels and the JAX
package's public digit contractions."""

from .base import (LegendreFunction, LegendreOracle, RSmoothFunction,
                   SmoothOracle)
from .f_oracles import (AX_b, DOptimalObj, DOptimalObjDS, DOptimalObjMixed,
                        FrobeniusSymLoss, FrobeniusSymLossDS,
                        FrobeniusSymLossMixed, KLdivRegression,
                        KLdivRegressionDS, KLdivRegressionMixed,
                        LogisticRegression, PoissonRegression,
                        PoissonRegressionDS, PoissonRegressionMixed, SVM_fun,
                        SVMfunMixed, calculate_tse_constant)
from .h_oracles import (BurgEntropy, BurgEntropyL1, BurgEntropyL2,
                        BurgEntropyL2Ball, BurgEntropySimplex, L2L1Linf,
                        PolyDiv, PowerNeg1, ShannonEntropy, ShannonEntropyL1,
                        ShannonEntropySimplex, SquaredL2Norm,
                        SumOf2nd4thPowers, SumOf2nd4thPowersDualProxMap,
                        SumOf2nd4thPowersOnSimplex,
                        SumOf2nd4thPowersPositiveOrthant,
                        SumOf2nd4thPowersPositiveOrthantDS,
                        SumOf2nd4thPowersWithFrankWolfe)
from .lmo import (lmo_l2_ball, lmo_l2_ball_positive_orthant, lmo_linf_ball,
                  lmo_matrix_box, lmo_matrix_simplex, lmo_nuclear_norm_ball,
                  lmo_simplex)
from .mixed_precision import (digit_split_matrix, digit_split_vector,
                              ozaki_gemv, ozaki_gemv_packed,
                              pack_digit_planes)
from .roots import (bisect_monotone, newton_scalar, project_simplex_burg,
                    simplex_inv_multiplier, solve_cubic)
from .simplex import simplex_inv_multiplier_pallas

__all__ = ["AX_b", "BurgEntropy", "BurgEntropyL1", "BurgEntropyL2",
           "BurgEntropyL2Ball", "BurgEntropySimplex", "DOptimalObj",
           "DOptimalObjDS", "DOptimalObjMixed", "digit_split_matrix",
           "digit_split_vector", "ozaki_gemv", "ozaki_gemv_packed",
           "pack_digit_planes",
           "FrobeniusSymLoss", "FrobeniusSymLossDS", "FrobeniusSymLossMixed",
           "KLdivRegression", "KLdivRegressionDS", "KLdivRegressionMixed",
           "L2L1Linf", "LegendreFunction", "LegendreOracle",
           "LogisticRegression", "PoissonRegression", "PoissonRegressionDS",
           "PoissonRegressionMixed", "PolyDiv", "PowerNeg1",
           "RSmoothFunction", "SVM_fun", "SVMfunMixed", "ShannonEntropy",
           "ShannonEntropyL1", "ShannonEntropySimplex", "SmoothOracle",
           "SquaredL2Norm", "SumOf2nd4thPowers",
           "SumOf2nd4thPowersDualProxMap",
           "SumOf2nd4thPowersOnSimplex", "SumOf2nd4thPowersPositiveOrthant",
           "SumOf2nd4thPowersPositiveOrthantDS",
           "SumOf2nd4thPowersWithFrankWolfe", "bisect_monotone",
           "calculate_tse_constant",
           "lmo_l2_ball", "lmo_l2_ball_positive_orthant", "lmo_linf_ball",
           "lmo_matrix_box", "lmo_matrix_simplex", "lmo_nuclear_norm_ball",
           "lmo_simplex", "newton_scalar", "project_simplex_burg",
           "simplex_inv_multiplier", "simplex_inv_multiplier_pallas",
           "solve_cubic"]
