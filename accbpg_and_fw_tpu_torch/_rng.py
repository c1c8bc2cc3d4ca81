"""The noise stream of stochastic (inexact) oracles.

The JAX drivers draw every noise sample from a linear chain of PRNG keys,
``(key, sub) = split(key)``, and hand ``sub`` to one draw.  The port keeps
that chain and its shape: a key is a host ``uint32[2]``, laid out as JAX's
``PRNGKey(seed)`` (high word, low word), so a driver's carry has the JAX
keys, shapes and dtypes and a checkpoint moves between the packages.

The bits are torch's, not JAX's: ``split`` derives the next key and a draw
key from torch's CPU generator seeded by the key, ``uniform`` draws a host
float the same way (no device work, no sync), and ``normal`` draws on the
oracle's device from a generator seeded by the draw key (the card and the
CPU generators give different normals for one seed).  Replacing these
three functions by ``jax.random``'s makes a noisy run draw JAX's samples.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF


def key(seed):
    """The chain's first key: JAX's ``PRNGKey(seed)`` words."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & _MASK], dtype=np.uint32)


def _seed(k):
    return (int(k[0]) << 32) | int(k[1])


def split(k):
    """``(next key, draw key)``: one link of the chain."""
    gen = torch.Generator().manual_seed(_seed(k))
    words = torch.randint(0, 1 << 32, (4,), generator=gen,
                          dtype=torch.int64).numpy().astype(np.uint32)
    return words[:2], words[2:]


def uniform(sub):
    """A host float in [0, 1) drawn from the draw key ``sub``."""
    gen = torch.Generator().manual_seed(_seed(sub))
    return torch.rand((), generator=gen, dtype=torch.float64).item()


def normal(sub, shape, device):
    """Standard normal float64 samples of ``shape`` on ``device``, drawn
    from the draw key ``sub``."""
    gen = torch.Generator(device=device).manual_seed(_seed(sub))
    return torch.randn(shape, generator=gen, dtype=torch.float64,
                       device=device)
