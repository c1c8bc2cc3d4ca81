"""Drop-in alias: ``import accbpg_torch`` -> accbpg_and_fw_tpu_torch.

The PyTorch/CUDA counterpart of ``accbpg`` (the JAX package's alias):
user scripts written against the reference package's ``accbpg`` names run
on the port with ``import accbpg_torch as accbpg``.
"""

from accbpg_and_fw_tpu_torch import *  # noqa: F401,F403
from accbpg_and_fw_tpu_torch import __all__, __version__  # noqa: F401
