"""Visualization and analysis (counterpart of ``accbpg_and_fw_tpu/viz``)."""

from .plotfigs import plot_comparisons
from .trianglescaling import plotTSE, plotTSE0, tse_curve

__all__ = ["plot_comparisons", "plotTSE", "plotTSE0", "tse_curve"]
