"""Distributed and batched layer (counterpart of
``accbpg_and_fw_tpu/parallel``).

Problems shard over a ``torch.distributed`` device mesh (``mesh.py``: the
design's columns, the samples of a regression, the rows of a SymNMF
matrix), with the m-by-m Grams and every solver scalar replicated; the
same drivers run on the sharded arrays.  ``vmap_solver`` vmaps a
single-instance solver, and ``dopt_fw_batch`` solves K D-opt instances
together.
"""

from .batched import dopt_fw_batch, vmap_solver
from .mesh import (data_mesh, distributed_init, shard_dopt_design,
                   shard_dopt_problem, shard_regression_problem,
                   shard_symnmf_problem)

__all__ = [
    "data_mesh",
    "distributed_init",
    "dopt_fw_batch",
    "shard_dopt_design",
    "shard_dopt_problem",
    "shard_regression_problem",
    "shard_symnmf_problem",
    "vmap_solver",
]
