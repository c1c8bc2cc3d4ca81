"""Exact-accumulation digit contractions (Ozaki-style int8 splits):
counterpart of the public functions of
``accbpg_and_fw_tpu/ops/mixed_precision.py`` (:29-:147).

The JAX package split f64 operands into radix-64 int8 digits so that its
D-opt engines could run f64-grade GEMVs on the TPU's int8 units.  Hopper
has FP64 in hardware and no solver of the port uses these functions; they
are here so a script that calls them moves across.  The digit products
are summed in float64, where every partial sum is an integer below 2^53
and so exact, as JAX's int32 sums are; the combine follows JAX's
expressions in JAX's order (``ozaki_gemv_packed`` keeps its float32
tail), so both packages return the same values.
"""

from __future__ import annotations

import torch

BASE = 64.0  # radix-64 digits: |digit| <= 64 fits int8; products <= 2^14


def _split(r, levels):
    planes = []
    for _ in range(levels):
        d = torch.round(r * BASE)
        planes.append(d.to(torch.int8))
        r = r * BASE - d
    return torch.stack(planes)


def digit_split_matrix(B, levels: int):
    """Split matrix B (float64, shape (m, n)) into int8 digit planes with
    per-column power-of-two scales.  Returns (digits[levels, m, n], s[n])
    with B == sum_p digits[p] * BASE**-(p+1) * s + O(BASE**-levels)."""
    B = torch.as_tensor(B, dtype=torch.float64)
    s = 2.0 ** torch.ceil(torch.log2(B.abs().amax(dim=0) + 1e-300))
    return _split(B / s, levels), s


def digit_split_vector(a, levels: int):
    """Split vector a into int8 digit planes with one power-of-two scale."""
    a = torch.as_tensor(a, dtype=torch.float64)
    s = 2.0 ** torch.ceil(torch.log2(a.abs().max() + 1e-300))
    return _split(a / s, levels), s


def pack_digit_planes(B_digits):
    """(levels, m, n) int8 -> (m, levels*n), so all digit-pair products of
    a GEMV are one contraction."""
    levels, m, n = B_digits.shape
    return B_digits.permute(1, 0, 2).reshape(m, levels * n)


def _mm(a, b):
    """Integer product of int8 digit operands, exact in float64."""
    return a.to(torch.float64) @ b.to(torch.float64)


def ozaki_gemv(a, B_digits, sB, levels_a: int = 7, max_diag: int = 6):
    """u = a @ B through exact digit products: digit pairs (p, q) with
    p + q <= max_diag, summed per diagonal and lifted with their shared
    exact scale."""
    levels_b = B_digits.shape[0]
    a_digits, sa = digit_split_vector(a, levels_a)
    n = B_digits.shape[2]
    out = torch.zeros(n, dtype=torch.float64, device=B_digits.device)
    for d in range(max_diag + 1):
        acc = None
        for p in range(max(0, d - levels_b + 1), min(d, levels_a - 1) + 1):
            r = _mm(a_digits[p], B_digits[d - p])
            acc = r if acc is None else acc + r
        if acc is not None:
            out = out + acc * (BASE ** -(d + 2))
    return out * (sa * sB)


def ozaki_gemv_packed(a, B_packed, sB, levels_b: int, levels_a: int = 7):
    """u = a @ B with all levels_a x levels_b digit pairs in one
    contraction against ``pack_digit_planes``' layout: the three leading
    diagonals lift to float64, the tail (<= BASE^-5 of the result) sums in
    float32, as in JAX."""
    n = B_packed.shape[1] // levels_b
    a_digits, sa = digit_split_vector(a, levels_a)
    prod = _mm(a_digits, B_packed).reshape(levels_a, levels_b, n)

    diags = []
    for d in range(levels_a + levels_b - 1):
        acc = None
        for p in range(max(0, d - levels_b + 1), min(d, levels_a - 1) + 1):
            term = prod[p, d - p]
            acc = term if acc is None else acc + term
        diags.append(acc)

    u = (diags[0] * BASE**-2 + diags[1] * BASE**-3 + diags[2] * BASE**-4)
    tail = torch.zeros(n, dtype=torch.float32, device=B_packed.device)
    for d in range(3, len(diags)):
        tail = tail + diags[d].to(torch.float32) * torch.tensor(
            BASE ** -(d + 2), dtype=torch.float32)
    u = u + tail.to(torch.float64)
    return u * (sa * sB)
