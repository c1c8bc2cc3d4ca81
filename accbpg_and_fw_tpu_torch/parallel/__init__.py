"""Batched multi-instance solving (counterpart of
``accbpg_and_fw_tpu/parallel``).  Ported so far: ``dopt_fw_batch``."""

from .batched import dopt_fw_batch

__all__ = ["dopt_fw_batch"]
