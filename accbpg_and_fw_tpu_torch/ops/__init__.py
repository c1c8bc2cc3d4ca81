"""Operator layer of the port (counterpart of ``accbpg_and_fw_tpu/ops``)."""
