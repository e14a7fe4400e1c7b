"""SO(3) machinery for equivariant GNNs (NequIP), l_max <= 2.

Counterpart of `repro/graph/so3.py`. The Clebsch-Gordan and real-basis
code is host numpy in float64, a copy of the reference's:
  * complex Clebsch-Gordan coefficients via the Racah formula (exact
    for the tiny l involved),
  * real-basis change U_l (standard real spherical harmonic convention),
  * real coupling tensors W[l1,l2,l3] := U3 . CG . (U1* x U2*), phase-fixed
    to be real,
  * real spherical harmonics (torch) in the closed form of the complex
    ones through U_l, so the basis convention is consistent with the
    coupling tensors by construction.

Conventions: the l=1 real basis is ordered (y, z, x), so D^1(R) = P R P^T
with P the (x,y,z)->(y,z,x) permutation.
"""
from __future__ import annotations

from functools import lru_cache
from math import factorial, sqrt

import numpy as np
import torch


# ---------------------------------------------------------------- complex CG
def _cg_complex(l1: int, l2: int, l3: int, m1: int, m2: int, m3: int) -> float:
    """<l1 m1 l2 m2 | l3 m3> via the Racah formula (exact floats, small l)."""
    if m3 != m1 + m2:
        return 0.0
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return 0.0
    if abs(m1) > l1 or abs(m2) > l2 or abs(m3) > l3:
        return 0.0
    f = factorial
    pre = sqrt(
        (2 * l3 + 1)
        * f(l3 + l1 - l2) * f(l3 - l1 + l2) * f(l1 + l2 - l3)
        / f(l1 + l2 + l3 + 1)
    )
    pre *= sqrt(f(l3 + m3) * f(l3 - m3)
                * f(l1 - m1) * f(l1 + m1) * f(l2 - m2) * f(l2 + m2))
    s = 0.0
    for k in range(0, l1 + l2 + l3 + 1):
        denoms = [l1 + l2 - l3 - k, l1 - m1 - k, l2 + m2 - k,
                  l3 - l2 + m1 + k, l3 - l1 - m2 + k]
        if any(d < 0 for d in denoms):
            continue
        s += (-1.0) ** k / (
            f(k) * f(denoms[0]) * f(denoms[1]) * f(denoms[2])
            * f(denoms[3]) * f(denoms[4]))
    return pre * s


@lru_cache(maxsize=None)
def cg_matrix_complex(l1: int, l2: int, l3: int) -> np.ndarray:
    """[2l1+1, 2l2+1, 2l3+1] complex-basis CG, m from -l..l."""
    out = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for i, m1 in enumerate(range(-l1, l1 + 1)):
        for j, m2 in enumerate(range(-l2, l2 + 1)):
            for k, m3 in enumerate(range(-l3, l3 + 1)):
                out[i, j, k] = _cg_complex(l1, l2, l3, m1, m2, m3)
    return out


# ------------------------------------------------------- real-basis change
@lru_cache(maxsize=None)
def real_basis_change(l: int) -> np.ndarray:
    """U_l with y_real = U_l @ y_complex; rows ordered m=-l..l (real),
    cols m=-l..l (complex, Condon-Shortley)."""
    n = 2 * l + 1
    U = np.zeros((n, n), dtype=np.complex128)
    for m in range(-l, l + 1):
        r = m + l
        if m == 0:
            U[r, l] = 1.0
        elif m > 0:
            U[r, -m + l] = 1 / sqrt(2)
            U[r, m + l] = ((-1) ** m) / sqrt(2)
        else:  # m < 0
            am = -m
            U[r, -am + l] = 1j / sqrt(2)
            U[r, am + l] = -1j * ((-1) ** am) / sqrt(2)
    return U


@lru_cache(maxsize=None)
def coupling_tensor(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis coupling W[i,j,k]: w_k = sum_ij W[i,j,k] u_i v_j.

    Phase-fixed to a real tensor (the complex result is e^{i phi} * real;
    the global phase is absorbed by learnable path weights)."""
    C = cg_matrix_complex(l1, l2, l3).astype(np.complex128)
    U1, U2, U3 = (real_basis_change(x) for x in (l1, l2, l3))
    W = np.einsum("ia,jb,abc,kc->ijk", np.conj(U1), np.conj(U2), C, U3)
    re, im = np.real(W), np.imag(W)
    if np.abs(im).max() > np.abs(re).max():
        assert np.abs(re).max() < 1e-10, (l1, l2, l3, np.abs(re).max())
        return np.ascontiguousarray(im)
    assert np.abs(im).max() < 1e-10, (l1, l2, l3, np.abs(im).max())
    return np.ascontiguousarray(re)


# --------------------------------------------------- real spherical harmonics
def real_sph_harm(vec: torch.Tensor, l_max: int = 2, eps: float = 1e-9):
    """Real spherical harmonics of unit(vec) for l=0..l_max.

    vec: [..., 3]. Returns {l: [..., 2l+1]} matching real_basis_change's
    conventions, normalized so that ||Y_l||^2 integrates to 1 on S^2."""
    if l_max >= 3:
        raise NotImplementedError("l_max <= 2 (assigned NequIP config)")
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r = torch.sqrt(x * x + y * y + z * z + eps)
    x, y, z = x / r, y / r, z / r
    out = {0: torch.full(vec.shape[:-1] + (1,), 0.5 * sqrt(1 / np.pi),
                         dtype=vec.dtype, device=vec.device)}
    if l_max >= 1:
        c1 = sqrt(3 / (4 * np.pi))
        out[1] = torch.stack([c1 * y, c1 * z, c1 * x], dim=-1)
    if l_max >= 2:
        c2 = 0.5 * sqrt(15 / np.pi)
        out[2] = torch.stack([
            c2 * x * y,                                     # m=-2
            c2 * y * z,                                     # m=-1
            0.25 * sqrt(5 / np.pi) * (3 * z * z - 1),       # m=0
            c2 * x * z,                                     # m=1
            0.5 * c2 * (x * x - y * y),                     # m=2
        ], dim=-1)
    return out


def check_l1_conventions() -> float:
    """Max deviation between the analytic real Y_1 (float64) and the
    U_1-transformed complex Y_1 on random directions (used by tests)."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(64, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    c = 0.5 * sqrt(3 / (2 * np.pi))
    Yc = np.stack([c * (x - 1j * y), 0.5 * sqrt(3 / np.pi) * z,
                   -c * (x + 1j * y)], axis=-1)   # m=-1,0,1 complex
    U1 = real_basis_change(1)
    Yr_from_complex = np.real(Yc @ U1.T)
    Yr = real_sph_harm(torch.as_tensor(v), 1)[1].numpy()
    return float(np.abs(Yr - Yr_from_complex).max())
