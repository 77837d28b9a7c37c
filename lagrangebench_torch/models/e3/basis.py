"""Numerically-constructed O(3) representation machinery.

Counterpart of ``lagrangebench_tpu/models/e3/basis.py``: the same numpy
construction (the port keeps its own copy) and the spherical harmonics in
torch.

Everything here runs once at model-build time in numpy (cached), so no
tables of Clebsch-Gordan coefficients are hardcoded:

* real spherical-harmonic basis polynomials up to l=3 in the (x, y, z)
  convention (orthonormal on the unit sphere),
* Wigner-D rotation matrices per l, obtained by least-squares projection of
  rotated basis polynomials onto the basis,
* Clebsch-Gordan intertwiners C[l1, l2 -> l3] as the (1-dimensional) null
  space of the rotation-equivariance constraints over a set of random
  rotations — exact to machine precision and self-consistent with the
  basis convention by construction.

Component normalization: each CG tensor is scaled so that
sum(C^2) = 2*l3 + 1, which keeps unit-variance inputs at unit variance.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, List

import numpy as np
import torch


@lru_cache(maxsize=None)
def _assoc_legendre_q(l: int, m: int) -> tuple:
    """Coefficients (ascending powers of z) of Q_{l,m}.

    P_l^m(z) = (1 - z^2)^{m/2} * Q_{l,m}(z) WITHOUT the Condon-Shortley
    phase; computed by the standard recurrence in exact polynomial
    arithmetic.
    """
    assert 0 <= m <= l

    def shift(c):  # multiply by z
        return np.concatenate([[0.0], c])

    q_mm = np.asarray([float(np.prod(np.arange(1, 2 * m, 2)))])  # (2m-1)!!
    if l == m:
        return tuple(q_mm)
    q_prev, q = q_mm, (2 * m + 1) * shift(q_mm)
    for ll in range(m + 2, l + 1):
        q_next = (
            (2 * ll - 1) * shift(q)
            - (ll + m - 1) * np.pad(q_prev, (0, 2))
        ) / (ll - m)
        q_prev, q = q, q_next
    return tuple(q)


@lru_cache(maxsize=None)
def _real_sh_terms(l: int) -> tuple:
    """Per-component (m, K, q_coeffs) for the degree-l real harmonics.

    Standard real basis, m ordered -l..l: sin(|m| phi) branches for m < 0,
    cos(m phi) for m > 0, both as Re/Im[(x+iy)^|m|] on the unit sphere;
    orthonormal w.r.t. the sphere measure (integral normalization).
    """
    terms = []
    for m in range(-l, l + 1):
        am = abs(m)
        K = math.sqrt(
            (2 * l + 1)
            / (4 * math.pi)
            * math.factorial(l - am)
            / math.factorial(l + am)
        )
        if m != 0:
            K *= math.sqrt(2.0)
        terms.append((m, K, _assoc_legendre_q(l, am)))
    return tuple(terms)


def _basis_polynomials(l: int) -> List[Callable[[np.ndarray], np.ndarray]]:
    """Real orthonormal spherical harmonics (as functions of unit vectors).

    Conventions: l=1 ordered (x, y, z) — a fixed permutation of the
    standard real basis kept for backwards compatibility of this engine's
    irreps layout; every other degree uses the standard real basis in
    m = -l..l order (which reproduces the original hand-written l=2/l=3
    lists exactly — pinned by tests).
    """
    c = 1.0 / np.sqrt(4 * np.pi)
    if l == 0:
        return [lambda v: c * np.ones(v.shape[:-1])]
    if l == 1:
        k = np.sqrt(3) * c
        return [
            lambda v: k * v[..., 0],
            lambda v: k * v[..., 1],
            lambda v: k * v[..., 2],
        ]

    def make(m, K, q):
        def f(v):
            x, y, z = v[..., 0], v[..., 1], v[..., 2]
            cplx = (x + 1j * y) ** abs(m)
            A = np.real(cplx) if m >= 0 else np.imag(cplx)
            Q = sum(coef * z**k for k, coef in enumerate(q))
            return K * A * Q

        return f

    return [make(m, K, q) for m, K, q in _real_sh_terms(l)]


@lru_cache(maxsize=None)
def _sample_points(n: int = 512, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _eval_basis(l: int, v: np.ndarray) -> np.ndarray:
    """(n_points, 2l+1) basis evaluations."""
    return np.stack([f(v) for f in _basis_polynomials(l)], axis=-1)


def _random_rotations(n: int, seed: int = 3) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    rots = []
    for _ in range(n):
        a = rng.normal(size=(3, 3))
        q, r = np.linalg.qr(a)
        q = q * np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        rots.append(q)
    return rots


def wigner_d(l: int, R: np.ndarray) -> np.ndarray:
    """Representation matrix of rotation R on the degree-l basis.

    D satisfies Y(R v) = D(R) Y(v) (as column vectors of basis values).
    """
    if l == 0:
        return np.ones((1, 1))
    if l == 1:
        # our l=1 basis IS (x, y, z): Y(Rv) = R Y(v)
        return np.asarray(R, dtype=np.float64)
    v = _sample_points()
    A = _eval_basis(l, v)  # (n, d)
    B = _eval_basis(l, v @ np.asarray(R).T)  # Y_k(R v_i)
    # solve B = A @ D^T  ->  D^T = lstsq(A, B)
    Dt, *_ = np.linalg.lstsq(A, B, rcond=None)
    D = Dt.T
    err = np.abs(D @ D.T - np.eye(2 * l + 1)).max()
    assert err < 1e-8, f"non-orthogonal Wigner D at l={l}: {err}"
    return D


@lru_cache(maxsize=None)
def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Intertwiner C of shape (2l1+1, 2l2+1, 2l3+1) in our basis.

    Defined (up to sign) by equivariance:
        C contracted with (D_l1 x, D_l2 y) = D_l3 (C contracted with (x, y))
    and normalized so sum(C^2) = 2*l3 + 1.
    """
    if not abs(l1 - l2) <= l3 <= l1 + l2:
        raise ValueError(f"({l1},{l2},{l3}) violates the triangle rule")
    if l1 == l2 == l3 == 0:
        return np.ones((1, 1, 1))
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    dim = d1 * d2 * d3

    # constraints: for each rotation, (D1 (x) D2 (x) I - I (x) I (x) D3) vec(C) = 0
    # using C[a,b,c]: sum_{a'b'} D1[a',a] D2[b',b] C[a',b',c]
    #                = sum_{c'} D3[c,c'] C[a,b,c']   for all a,b,c
    K = np.zeros((dim, dim))
    for R in _random_rotations(8):
        D1, D2, D3 = wigner_d(l1, R), wigner_d(l2, R), wigner_d(l3, R)
        # LHS operator: C -> einsum('pa,qb,pqc->abc', D1, D2, C)
        L = np.einsum("pa,qb->abpq", D1, D2).reshape(d1 * d2, d1 * d2)
        L = np.kron(L, np.eye(d3))
        # RHS operator: C -> einsum('cd,abd->abc', D3, C)
        Rop = np.kron(np.eye(d1 * d2), D3)
        M = L - Rop
        K += M.T @ M

    w, vecs = np.linalg.eigh(K)
    assert w[0] < 1e-8, f"no intertwiner found for ({l1},{l2},{l3}): {w[0]}"
    # the SO(3) intertwiner space is 1-dimensional
    assert w[1] > 1e-6, f"degenerate intertwiner space for ({l1},{l2},{l3})"
    C = vecs[:, 0].reshape(d1, d2, d3)
    C = C * np.sqrt(d3) / np.linalg.norm(C)
    # canonical sign: first element with the largest magnitude is positive
    flat = C.reshape(-1)
    idx = np.argmax(np.abs(flat) > 1e-6)
    if flat[idx] < 0:
        C = -C
    return C


def spherical_harmonics_fn(lmax: int):
    """Return fn(x: (..., 3)) -> (..., sum(2l+1)) evaluating Y_0..Y_lmax.

    Inputs are normalized first (e3nn `normalize=True`); normalization is
    "integral" (orthonormal on the sphere). Differentiable torch ops, in
    the input's dtype.
    """
    c = float(1.0 / np.sqrt(4 * np.pi))
    terms = {l: [(m, float(K), [float(q) for q in qs]) for m, K, qs in _real_sh_terms(l)]
             for l in range(2, lmax + 1)}

    def sh(x):
        sq = torch.sum(x**2, dim=-1, keepdim=True)
        n = x / torch.sqrt(torch.where(sq == 0.0, torch.ones_like(sq), sq))
        xx, yy, zz = n[..., 0], n[..., 1], n[..., 2]
        # zero input has no direction: all l > 0 components must vanish or
        # the constant m=0 terms (Q_l(0) != 0 for even l) break equivariance
        # on self-edges; the guarded "direction" (0,0,0) already zeroes
        # every component with an x/y/z factor, this handles the rest
        nonzero = (sq[..., 0] > 0.0).to(x.dtype)
        comps = [c * torch.ones_like(xx)]
        if lmax >= 1:
            k = float(np.sqrt(3)) * c
            comps += [k * xx, k * yy, k * zz]
        if lmax >= 2:
            # Re/Im[(x+iy)^m] via the Chebyshev-style recurrence:
            # re_{m+1} = re_m*x - im_m*y ; im_{m+1} = im_m*x + re_m*y
            re = {0: torch.ones_like(xx), 1: xx}
            im = {0: torch.zeros_like(xx), 1: yy}
            for m in range(2, lmax + 1):
                re[m] = re[m - 1] * xx - im[m - 1] * yy
                im[m] = im[m - 1] * xx + re[m - 1] * yy
            zpow = {0: torch.ones_like(zz), 1: zz}
            for p in range(2, lmax + 1):
                zpow[p] = zpow[p - 1] * zz
            for l in range(2, lmax + 1):
                for m, K, q in terms[l]:
                    A = re[abs(m)] if m >= 0 else im[abs(m)]
                    Q = sum(coef * zpow[k] for k, coef in enumerate(q))
                    comps.append(K * A * Q * nonzero)
        return torch.stack(comps, dim=-1)

    return sh
