"""Problem factories and data utilities of the port (counterpart of
``accbpg_and_fw_tpu/apps``)."""

from .applications import (D_opt_design, D_opt_KYinit, D_opt_libsvm,
                           FrobeniusSymLossExL2Ball,
                           FrobeniusSymLossExLInfBall,
                           FrobeniusSymLossExWithLinearCnstrnts,
                           FrobeniusSymLossResMeasEx, KL_nonneg_regr,
                           L0L1_FW_log_reg, L0L1_FW_log_reg_a9a,
                           Poisson_regr_simplex, Poisson_regr_simplex_acc,
                           Poisson_regrL1, Poisson_regrL2,
                           hard_FW_log_reg_jax, load_a9a_data,
                           svm_digits_ds_divs_ball, toeplitz_matrix)
from .utils import (binary_error_rate, edge_point_on_simplex,
                    generate_dataset_for_svm, get_random_float,
                    get_random_vector, load_libsvm_file, load_sido,
                    mnist_2digits, random_point_in_l2_ball,
                    random_point_in_l2_ball_jax_version,
                    random_point_on_simplex, rmse, row_norm_squared,
                    shuffle_data)

__all__ = ["D_opt_design", "D_opt_KYinit", "D_opt_libsvm",
           "FrobeniusSymLossExL2Ball", "FrobeniusSymLossExLInfBall",
           "FrobeniusSymLossExWithLinearCnstrnts",
           "FrobeniusSymLossResMeasEx", "KL_nonneg_regr", "L0L1_FW_log_reg",
           "L0L1_FW_log_reg_a9a", "Poisson_regr_simplex",
           "Poisson_regr_simplex_acc", "Poisson_regrL1", "Poisson_regrL2",
           "binary_error_rate", "edge_point_on_simplex",
           "generate_dataset_for_svm", "get_random_float",
           "get_random_vector", "hard_FW_log_reg_jax", "load_a9a_data",
           "load_libsvm_file", "load_sido", "mnist_2digits",
           "random_point_in_l2_ball", "random_point_in_l2_ball_jax_version",
           "random_point_on_simplex", "rmse",
           "row_norm_squared", "shuffle_data", "svm_digits_ds_divs_ball",
           "toeplitz_matrix"]
