"""The slice as a whole: the README example (``examples/ex_Dopt_random.py``)
through the port's BPG-family drivers with the kernel route of the prox,
``BurgEntropySimplex(use_pallas=True)`` (on the CPU the kernel's plain
version), at 80x200 seed 10.  Each run gives finite F over its 900
iterations; BPG and ABPG end within 0.05 of the reference trace's 17.59
and 17.585 (``tests/test_algorithms.py``'s bars), and BPG with its line
search descends monotonically.
"""

import numpy as np
import torch

import accbpg_and_fw_tpu_torch as port

torch.set_num_threads(1)


def test_readme_example_through_the_kernel_route():
    """examples/ex_Dopt_random.py's BPG, ABPG, ABPG_expo and ABPG_gain
    calls at 80x200 seed 10 with ``use_pallas=True``."""
    f, _, L, x0 = port.D_opt_design(80, 200, randseed=10, device="cpu")
    h = port.BurgEntropySimplex(use_pallas=True)
    n = 900
    F_bpg = port.BPG(f, h, L, x0, maxitrs=n, linesearch=True, ls_ratio=2,
                     verbose=False)[1]
    F_abpg = port.ABPG(f, h, L, x0, gamma=2.0, maxitrs=n, theta_eq=True,
                       verbose=False)[1]
    F_expo = port.ABPG_expo(f, h, L, x0, gamma0=3, maxitrs=n, theta_eq=True,
                            Gmargin=100, verbose=False)[1]
    F_gain = port.ABPG_gain(f, h, L, x0, gamma=2, maxitrs=n, G0=0.1,
                            theta_eq=True, verbose=False)[1]
    for F in (F_bpg, F_abpg, F_expo, F_gain):
        assert len(F) == n and np.all(np.isfinite(F))
    assert abs(F_bpg[-1] - 17.59) < 0.05
    assert abs(F_abpg[-1] - 17.585) < 0.05
    assert np.all(np.diff(F_bpg) < 1e-8)  # monotone descent with LS
