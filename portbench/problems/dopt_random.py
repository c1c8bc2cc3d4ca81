"""Random D-optimal design instances, drawn as the reference's
``apps.D_opt_design`` draws them: V with i.i.d. standard normal entries,
the Burg entropy on the simplex, L = 1 and the uniform start.

``make`` draws ``count`` designs of the configuration's m x n in one call
on the device, from a generator seeded with the run's seed (the same seed
gives the same designs), in float64, the type the solvers take.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pool(NamedTuple):
    V: torch.Tensor    # (count, m, n) float64
    x0: torch.Tensor   # (n,) the uniform start
    count: int


def make(config, count, seed, device):
    m, n = int(config["m"]), int(config["n"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    V = torch.randn((count, m, n), generator=gen, dtype=torch.float64,
                    device=device)
    x0 = torch.full((n,), 1.0 / n, dtype=torch.float64, device=device)
    return Pool(V, x0, count)
