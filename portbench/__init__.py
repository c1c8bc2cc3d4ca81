"""The benchmark of ``accbpg_and_fw_tpu_torch`` (see ``README.md``)."""
