"""Problem factories of the port (counterpart of
``accbpg_and_fw_tpu/apps``)."""

from .applications import D_opt_KYinit

__all__ = ["D_opt_KYinit"]
