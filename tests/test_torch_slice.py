"""The port's slice as a whole: ``D_opt_FW_away(..., u_mode="auto")`` with
the lazy engine forced (on the CPU "auto" picks the exact engine, so the
routing is patched), against the JAX package at the lazy engine's bars
(F rtol 1e-9, x atol 1e-11 against the exact engine; SP atol 1e-9 against
the JAX lazy kernel in interpret mode), plus the package's boundaries: no
JAX imports, no silent device fallback, and the device rule (the card
unless the caller asks for the CPU) at every public entry point.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu.ops.pallas_dopt_lazy import dopt_fw_pallas_lazy
from accbpg_and_fw_tpu_torch import interop
from accbpg_and_fw_tpu_torch._device import resolve_device
from accbpg_and_fw_tpu_torch.algorithms import d_opt as port_dopt
from accbpg_and_fw_tpu_torch.ops import dopt_dense as dd
from accbpg_and_fw_tpu_torch.ops import dopt_lazy as dl
from accbpg_and_fw_tpu_torch.parallel import batched as pb

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)

PKG = pathlib.Path(port.__file__).resolve().parent


@pytest.fixture
def lazy_auto(monkeypatch):
    """Route u_mode="auto" to the lazy engine whatever the device."""
    real = port_dopt._resolve_auto_u_mode

    def forced(V, u_mode, device):
        return "pallas_lazy" if u_mode == "auto" else real(V, u_mode, device)

    monkeypatch.setattr(port_dopt, "_resolve_auto_u_mode", forced)


def test_slice_auto_matches_jax(lazy_auto):
    V = np.random.default_rng(3).standard_normal((12, 160))
    x0 = np.full(160, 1.0 / 160)
    launches = dl.LAUNCHES
    x, F, SP, SN, T = port.D_opt_FW_away(V, x0, 1e-8, 60, verbose=False,
                                         u_mode="auto", device="cpu")
    assert dl.LAUNCHES == launches  # CPU tensors take the plain block
    xe, Fe, *_ = acc.D_opt_FW_away(V, x0, 1e-8, 60, verbose=False,
                                   u_mode="auto")
    np.testing.assert_allclose(F, Fe, rtol=1e-9)
    np.testing.assert_allclose(x.numpy(), np.asarray(xe), rtol=0, atol=1e-11)
    xl, Fl, SPl, *_ = dopt_fw_pallas_lazy(V, x0, 1e-8, 60, verbose=False,
                                          interpret=True, group=1)
    np.testing.assert_allclose(SP.astype(np.float32).astype(np.float64),
                               np.asarray(SPl, np.float64), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(x.numpy(), np.asarray(xl), rtol=0, atol=1e-11)


def test_slice_golden_to_eps(lazy_auto):
    """30x300 seed 10 to eps=1e-7 through the lazy engine: iterations-to-
    eps within 1% of the JAX exact engine, and the final iterate certified
    by a fresh f64 slogdet, as the main path certifies its own."""
    f, h, L, x0 = acc.D_opt_design(30, 300, randseed=10)
    V, x0 = np.asarray(f.H), np.asarray(x0)
    x, F, SP, SN, T = port.D_opt_FW_away(V, x0, eps=1e-7, maxitrs=20000,
                                         verbose=False, device="cpu")
    _, Fe, *_ = acc.D_opt_FW_away(V, x0, eps=1e-7, maxitrs=20000,
                                  verbose=False, chunk=1000)
    print(f"iterations to eps: jax exact {len(Fe)}, port lazy {len(F)}")
    assert abs(len(F) - len(Fe)) <= 0.01 * len(Fe)
    assert SP[-1] <= 1e-7 and SN[-1] <= 1e-7
    xs = x.numpy() / x.numpy().sum()
    sign, logdet = np.linalg.slogdet((V * xs) @ V.T)
    assert sign > 0
    assert abs(-logdet - Fe[-1]) <= 1e-6
    assert abs(F[-1] - (-logdet)) <= 1e-6


@pytest.mark.parametrize("device,shape,expected", [
    ("cuda", (1000, 1800), "pallas_lazy"),
    ("cuda", (1000, 1799), "exact"),
    ("cpu", (1000, 5000), "exact"),
])
def test_auto_routing_rule(device, shape, expected):
    V = torch.empty(shape, dtype=torch.float64, device="meta")
    got = port_dopt._resolve_auto_u_mode(V, "auto", torch.device(device))
    assert got == expected


def test_package_imports_no_jax():
    """The port imports torch and never jax, nor the JAX package."""
    bad = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|accbpg_and_fw_tpu(?!_torch)\w*|"
        r"accbpg)\b", re.M)
    sources = sorted(PKG.rglob("*.py"))
    assert sources
    offenders = [str(p.relative_to(PKG)) for p in sources
                 if bad.search(p.read_text())]
    assert offenders == []
    smoke = PKG.parent / "chip_smoke.py"
    assert not bad.search(smoke.read_text())


def test_cuda_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    V = np.random.default_rng(0).standard_normal((4, 20))
    x0 = np.full(20, 1.0 / 20)
    with pytest.raises(RuntimeError, match="cuda"):
        port.D_opt_FW_away(V, x0, 1e-8, 5, verbose=False, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        port.D_opt_FW(V, x0, 1e-8, 5, verbose=False, device="cuda")


def test_numpy_input_defaults_to_the_card(monkeypatch):
    """The port's default is the card, not the CPU: a numpy input with no
    ``device`` raises where there is no card (it does not fall back), and
    ``device="cpu"`` is how a caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    V = np.random.default_rng(0).standard_normal((4, 20))
    with pytest.raises(RuntimeError, match="default is CUDA"):
        port.D_opt_FW_away(V, np.full(20, 0.05), 1e-8, 5, verbose=False)
    x, *_ = port.D_opt_FW_away(V, np.full(20, 0.05), 1e-8, 5, verbose=False,
                               device="cpu")
    assert x.device.type == "cpu" and x.dtype == torch.float64


# the name this test had while the default was the CPU, kept so that runs
# of the tests stay comparable by name
test_numpy_input_defaults_to_cpu = test_numpy_input_defaults_to_the_card


def test_cpu_tensor_keeps_its_device(monkeypatch):
    """A tensor input with no ``device`` stays where it is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    V = torch.tensor(np.random.default_rng(0).standard_normal((4, 20)))
    assert resolve_device(None, like=V) == torch.device("cpu")
    x, *_ = port.D_opt_FW_away(V, np.full(20, 0.05), 1e-8, 5, verbose=False)
    assert x.device.type == "cpu"
    for shape in ((4, 20), (4, 6)):  # the Gram-Schmidt start, the uniform
        assert port.D_opt_KYinit(V[:, :shape[1]]).device.type == "cpu"
    with pytest.raises(RuntimeError, match="default is CUDA"):
        resolve_device(None, like=V.numpy())
    with pytest.raises(RuntimeError, match="default is CUDA"):
        resolve_device(None)
    assert resolve_device("cpu", like=V.numpy()) == torch.device("cpu")


class DOptimalObj:
    """Stands in for the JAX oracle of that name, which ``from_jax_oracle``
    reads through its attributes."""

    def __init__(self, H):
        self.H, self.n_valid = H, None


_V = np.random.default_rng(0).standard_normal((4, 20))
_VS = np.random.default_rng(1).standard_normal((2, 4, 20))
_X0 = np.full(20, 0.05)
_X0S = np.full((2, 20), 0.05)
_H = np.linalg.inv((_V * _X0) @ _V.T)
_CARRY = dict(x=_X0, w=np.einsum("ij,ij->j", _V, _H @ _V), H=_H,
              logdet=np.linalg.slogdet((_V * _X0) @ _V.T)[1])

# every public entry point that takes a device: a call with numpy inputs
# and the device keywords it is given, and where its result's device shows
ENTRY_POINTS = {
    "D_opt_FW_away": (lambda **kw: port.D_opt_FW_away(
        _V, _X0, 1e-8, 3, verbose=False, **kw), lambda out: out[0]),
    "D_opt_FW": (lambda **kw: port.D_opt_FW(
        _V, _X0, 1e-8, 3, verbose=False, **kw), lambda out: out[0]),
    "dopt_fw_batch": (lambda **kw: port.dopt_fw_batch(
        _VS, _X0S, 1e-8, 3, **kw), lambda out: out[0]),
    "dopt_fw_batch_exact": (lambda **kw: pb.dopt_fw_batch_exact(
        _VS, _X0S, 1e-8, 3, **kw), lambda out: out[0]),
    "dopt_fw_lazy": (lambda **kw: dl.dopt_fw_lazy(
        _V, _X0, 1e-8, 3, verbose=False, **kw), lambda out: out[0]),
    "dopt_fw_lazy_batch": (lambda **kw: dl.dopt_fw_lazy_batch(
        _VS, _X0S, 1e-8, 3, **kw), lambda out: out[0]),
    "dopt_fw_dense": (lambda **kw: dd.dopt_fw_dense(
        _V, _X0, 1e-8, 3, verbose=False, **kw), lambda out: out[0]),
    "dopt_fw_dense_batch": (lambda **kw: dd.dopt_fw_dense_batch(
        _VS, _X0S, 1e-8, 3, **kw), lambda out: out[0]),
    "D_opt_design": (lambda **kw: port.D_opt_design(4, 20, randseed=1, **kw),
                     lambda out: out[3]),
    "D_opt_KYinit": (lambda **kw: port.D_opt_KYinit(_V, **kw),
                     lambda out: out),
    "DOptimalObj": (lambda **kw: port.DOptimalObj(_V, **kw),
                    lambda out: out.H),
    "from_jax_oracle": (lambda **kw: interop.from_jax_oracle(
        DOptimalObj(_V), **kw), lambda out: out.H),
    "from_jax_carry": (lambda **kw: interop.from_jax_carry(_CARRY, **kw),
                       lambda out: out["x"]),
    "continue_dopt": (lambda **kw: interop.continue_dopt(
        _V, interop.from_jax_carry(_CARRY, device="cpu"), 1e-8, 3, **kw),
        lambda out: out[0]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_honours_the_device_rule(monkeypatch, name):
    """Numpy input and no ``device``: the card, so without one the call
    raises; ``device="cpu"`` runs on the CPU; ``device="cuda"`` without a
    card raises too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call, tensor_of = ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="default is CUDA"):
        call()
    with pytest.raises(RuntimeError, match="'cuda' was requested"):
        call(device="cuda")
    assert tensor_of(call(device="cpu")).device.type == "cpu"
