"""continuations_per_kiter.fastgram: as ``continuations_per_kiter.fw``."""

from pathlib import Path

from portbench.core.registry import load_module

_FW = load_module("metrics", "continuations_per_kiter.fw",
                  Path(__file__).resolve().parent.parent)
snapshot, read = _FW.snapshot, _FW.read
