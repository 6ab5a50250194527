"""Minimal real-SO(3) representation machinery for MACE, the counterpart of
``repro.models.gnn.so3`` (no e3nn).

Provides, for l <= L_MAX (default 3):
- real spherical harmonics of unit vectors (closed forms, orthonormalized)
- real-basis Clebsch-Gordan coupling tensors C^{l1 l2 l3} built from the
  complex CG coefficients (Racah's formula) conjugated by the unitary
  complex->real change of basis, with the i^{l1+l2-l3} phase folded in so
  the result is purely real.

Conventions: real SH ordered m = -l..l; the l=1 triple is (y, z, x) in the
standard real-SH convention, i.e. S_{1,-1} ∝ y, S_{1,0} ∝ z, S_{1,1} ∝ x.
Correctness is pinned by tests: norm-invariance of couplings under random
rotations and the Gaunt selection rules.

The numpy part (Racah's formula, the change of basis, ``cg_real_racah``,
``cg_real``) is the reference's, line for line, and ``wigner_d_real``
evaluates the probe harmonics in float32 as the reference does, so the
coupling tensors equal the reference's bit for bit. ``real_sph_harm``
takes and returns torch tensors.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict

import numpy as np
import torch

__all__ = ["real_sph_harm", "cg_real", "wigner_d_real", "irrep_dims"]


def irrep_dims(l_max: int):
    return {l: 2 * l + 1 for l in range(l_max + 1)}


# --------------------------------------------------------------------------
# complex Clebsch-Gordan via Racah's formula
# --------------------------------------------------------------------------
@lru_cache(maxsize=None)
def _fact(n: int) -> float:
    return math.factorial(n)


def _cg_complex_coeff(j1, m1, j2, m2, j3, m3) -> float:
    """<j1 m1 j2 m2 | j3 m3> (Condon-Shortley), Racah's formula."""
    if m3 != m1 + m2:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0
    pref = (2 * j3 + 1) * _fact(j3 + j1 - j2) * _fact(j3 - j1 + j2) * _fact(
        j1 + j2 - j3
    ) / _fact(j1 + j2 + j3 + 1)
    pref *= (
        _fact(j3 + m3)
        * _fact(j3 - m3)
        * _fact(j1 - m1)
        * _fact(j1 + m1)
        * _fact(j2 - m2)
        * _fact(j2 + m2)
    )
    pref = math.sqrt(pref)
    s = 0.0
    for k in range(0, j1 + j2 + j3 + 1):
        d1 = j1 + j2 - j3 - k
        d2 = j1 - m1 - k
        d3 = j2 + m2 - k
        d4 = j3 - j2 + m1 + k
        d5 = j3 - j1 - m2 + k
        if min(d1, d2, d3, d4, d5) < 0:
            continue
        s += (-1.0) ** k / (
            _fact(k) * _fact(d1) * _fact(d2) * _fact(d3) * _fact(d4) * _fact(d5)
        )
    return pref * s


@lru_cache(maxsize=None)
def _cg_complex(l1: int, l2: int, l3: int) -> np.ndarray:
    """[2l1+1, 2l2+1, 2l3+1] complex-basis CG, index m = -l..l."""
    out = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for i1, m1 in enumerate(range(-l1, l1 + 1)):
        for i2, m2 in enumerate(range(-l2, l2 + 1)):
            for i3, m3 in enumerate(range(-l3, l3 + 1)):
                out[i1, i2, i3] = _cg_complex_coeff(l1, m1, l2, m2, l3, m3)
    return out


@lru_cache(maxsize=None)
def _complex_to_real(l: int) -> np.ndarray:
    """U with S_real = U @ Y_complex (rows m_r = -l..l, cols m_c = -l..l)."""
    d = 2 * l + 1
    u = np.zeros((d, d), complex)
    for i, m in enumerate(range(-l, l + 1)):
        if m < 0:
            u[i, l + m] = 1j / math.sqrt(2)
            u[i, l - m] = -1j * (-1) ** m / math.sqrt(2)
        elif m == 0:
            u[i, l] = 1.0
        else:
            u[i, l - m] = 1 / math.sqrt(2)
            u[i, l + m] = (-1) ** m / math.sqrt(2)
    return u


@lru_cache(maxsize=None)
def cg_real_racah(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis coupling via the algebraic U CG U^dagger route (kept for
    cross-checks; the model uses :func:`cg_real`, which is pinned to the
    same convention as :func:`real_sph_harm` by construction)."""
    cg = _cg_complex(l1, l2, l3)
    u1 = _complex_to_real(l1)
    u2 = _complex_to_real(l2)
    u3 = _complex_to_real(l3)
    c = np.einsum("am,bn,ko,mno->abk", u1, u2, np.conj(u3), cg)
    phase = (-1j) ** (l1 + l2 - l3)
    c = phase * c
    assert np.abs(c.imag).max() < 1e-10, (l1, l2, l3, np.abs(c.imag).max())
    return np.ascontiguousarray(c.real)


@lru_cache(maxsize=None)
def cg_real(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis coupling tensor C[a, b, c] such that

        f_c(x, y) = sum_ab C[a,b,c] x_a y_b   satisfies
        f(D1 x, D2 y) = D3 f(x, y)            for every rotation,

    with D_l the real Wigner matrices OF THIS MODULE's spherical-harmonic
    convention. Constructed numerically as the (multiplicity-1) invariant
    subspace of the rep constraint — exact to machine precision, and
    immune to phase/ordering convention mismatches between the algebraic
    CG route and the SH closed forms (which bit us at l=2).
    """
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((d1, d2, d3))
    rng = np.random.default_rng(1234 + 100 * l1 + 10 * l2 + l3)
    rows = []
    for _ in range(6):
        a = rng.normal(size=(3, 3))
        q, r = np.linalg.qr(a)
        q *= np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        dd1 = wigner_d_real(l1, q)
        dd2 = wigner_d_real(l2, q)
        dd3 = wigner_d_real(l3, q)
        # linear map L(C)[a',b',c] = sum_ab C[a,b,c] D1[a,a'] D2[b,b']
        #                            - sum_c' D3[c,c'] C[a',b',c']
        lhs = np.einsum("aA,bB->abAB", dd1, dd2).reshape(d1 * d2, d1 * d2)
        m = np.kron(lhs.T, np.eye(d3)) - np.kron(np.eye(d1 * d2), dd3)
        # vec ordering: C[a,b,c] -> index ((a*d2)+b)*d3 + c
        rows.append(m)
    m = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(m)
    c = vt[-1].reshape(d1, d2, d3)
    # precision floor set by the lstsq-derived Wigner matrices (~1e-7)
    assert s[-1] < 1e-5, (l1, l2, l3, s[-1])
    if d1 * d2 * d3 > 1:
        assert s[-2] > 1e-3, ("multiplicity > 1?", l1, l2, l3)
    # deterministic sign + unit Frobenius norm (scale absorbed by weights)
    flat = c.ravel()
    c = c * np.sign(flat[np.argmax(np.abs(flat))])
    return np.ascontiguousarray(c / np.linalg.norm(c))


# --------------------------------------------------------------------------
# real spherical harmonics (orthonormal, m = -l..l), closed forms to l=3
# --------------------------------------------------------------------------
def real_sph_harm(vec, l_max: int) -> Dict[int, torch.Tensor]:
    """vec: [..., 3] (need not be normalized — we normalize). Returns
    {l: [..., 2l+1]} orthonormal real SH values.

    Degenerate (near-zero) vectors get Y_l = 0 for l >= 1: the direction
    of a zero vector is undefined and any nonzero value would break
    rotation equivariance (self-loop edges hit this)."""
    eps = 1e-12
    r = torch.sqrt((vec * vec).sum(-1, keepdim=True) + eps)
    nondegenerate = (r[..., 0] > 1e-6)[..., None]
    x, y, z = (vec / r)[..., 0], (vec / r)[..., 1], (vec / r)[..., 2]
    out: Dict[int, torch.Tensor] = {}
    c0 = 0.5 * math.sqrt(1.0 / math.pi)
    out[0] = torch.full(vec.shape[:-1] + (1,), c0, dtype=vec.dtype,
                        device=vec.device)
    if l_max >= 1:
        c1 = math.sqrt(3.0 / (4 * math.pi))
        out[1] = torch.stack([c1 * y, c1 * z, c1 * x], dim=-1)
    if l_max >= 2:
        c2 = [
            0.5 * math.sqrt(15.0 / math.pi),   # xy
            0.5 * math.sqrt(15.0 / math.pi),   # yz
            0.25 * math.sqrt(5.0 / math.pi),   # 3z^2-1
            0.5 * math.sqrt(15.0 / math.pi),   # zx
            0.25 * math.sqrt(15.0 / math.pi),  # x^2-y^2
        ]
        out[2] = torch.stack(
            [
                c2[0] * x * y,
                c2[1] * y * z,
                c2[2] * (3 * z * z - 1.0),
                c2[3] * z * x,
                c2[4] * (x * x - y * y),
            ],
            dim=-1,
        )
    if l_max >= 3:
        c3 = [
            0.25 * math.sqrt(35.0 / (2 * math.pi)),
            0.5 * math.sqrt(105.0 / math.pi),
            0.25 * math.sqrt(21.0 / (2 * math.pi)),
            0.25 * math.sqrt(7.0 / math.pi),
            0.25 * math.sqrt(21.0 / (2 * math.pi)),
            0.25 * math.sqrt(105.0 / math.pi),
            0.25 * math.sqrt(35.0 / (2 * math.pi)),
        ]
        out[3] = torch.stack(
            [
                c3[0] * y * (3 * x * x - y * y),
                c3[1] * x * y * z,
                c3[2] * y * (5 * z * z - 1.0),
                c3[3] * z * (5 * z * z - 3.0),
                c3[4] * x * (5 * z * z - 1.0),
                c3[5] * z * (x * x - y * y),
                c3[6] * x * (x * x - 3 * y * y),
            ],
            dim=-1,
        )
    if l_max >= 4:
        raise NotImplementedError("real_sph_harm implemented to l=3")
    for l in range(1, l_max + 1):
        out[l] = torch.where(nondegenerate, out[l], 0.0)
    return out


def wigner_d_real(l: int, rot: np.ndarray) -> np.ndarray:
    """Real Wigner-D for rotation matrix ``rot`` (3x3), via the SH of a
    frame of probe vectors — numerically robust for tests (l <= 3).

    The probe harmonics are taken in float32, as the reference takes them
    (``jnp.asarray`` of float64 probes is float32 there)."""
    # Build D by least squares: SH(R v_i) = D @ SH(v_i) for probe set v_i.
    rng = np.random.default_rng(0)
    v = rng.normal(size=(max(16, 4 * (2 * l + 1)), 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    a = real_sph_harm(torch.as_tensor(v, dtype=torch.float32), l)[l].numpy()
    b = real_sph_harm(torch.as_tensor(v @ rot.T, dtype=torch.float32),
                      l)[l].numpy()
    d, *_ = np.linalg.lstsq(a, b, rcond=None)
    return d.T  # SH(Rv) = D @ SH(v)
