"""Multi-user zero-forcing precoding as batched planar linear algebra.

Math per reference ``createZeroForcingMatrix`` (cpuLS.hpp:415-447): per
subcarrier, W = H^H (H H^H)^{-1} -- the Moore-Penrose right-inverse of the
users x antennas channel, built there with per-subcarrier cgemm + cgetrf/
cgetri loops.  Here the whole subcarrier axis is one batched computation.

Complex-free solve: the U x U complex Gram system (H H^H) G = I is embedded
as the standard 2U x 2U real block system [[A, -B], [B, A]] [Gr; Gi] = [I; 0]
and handed to the batched real ``jnp.linalg.solve`` (LU on fp32).

Applied per ``multiplyWithChannelInv`` (cpuLS.hpp:449-463): per-subcarrier
y_ant = W @ x_users (cgemv loop in the reference, one planar einsum here).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .cplx import CArray, ceinsum

# No TF32 on the GPU: the Gram matrix and the precoder keep fp32 accuracy.
_PRECISION = jax.lax.Precision.HIGHEST


def _gram(h: CArray) -> CArray:
    """G = H H^H over the last two axes: [..., U, A] -> [..., U, U]."""
    # (H H^H)_uv = sum_a H_ua * conj(H_va)
    rr = jnp.einsum("...ua,...va->...uv", h.re, h.re, precision=_PRECISION)
    ii = jnp.einsum("...ua,...va->...uv", h.im, h.im, precision=_PRECISION)
    ri = jnp.einsum("...ua,...va->...uv", h.re, h.im, precision=_PRECISION)
    ir = jnp.einsum("...ua,...va->...uv", h.im, h.re, precision=_PRECISION)
    return CArray(rr + ii, ir - ri)


def _solve_hermitian(g: CArray, u: int) -> CArray:
    """Solve G X = I for complex G via the real 2U x 2U block embedding."""
    top = jnp.concatenate([g.re, -g.im], axis=-1)
    bot = jnp.concatenate([g.im, g.re], axis=-1)
    m = jnp.concatenate([top, bot], axis=-2)            # [..., 2U, 2U]
    eye = jnp.eye(u, dtype=g.re.dtype)
    rhs = jnp.concatenate([eye, jnp.zeros((u, u), g.re.dtype)], axis=0)
    rhs = jnp.broadcast_to(rhs, m.shape[:-2] + (2 * u, u))
    sol = jnp.linalg.solve(m, rhs)                       # [..., 2U, U]
    return CArray(sol[..., :u, :], sol[..., u:, :])


def zf_precoder(h: CArray) -> CArray:
    """Per-subcarrier zero-forcing precoder.

    Args:
      h: [..., U, A] planar channel (U users, A >= U antennas).

    Returns:
      [..., A, U] planar precoder with h @ w == I_U.
    """
    u = h.shape[-2]
    g = _gram(h)
    ginv = _solve_hermitian(g, u)
    # W = H^H Ginv : [..., A, U]
    hconj_t = CArray(jnp.swapaxes(h.re, -1, -2), -jnp.swapaxes(h.im, -1, -2))
    return ceinsum("...au,...uv->...av", hconj_t, ginv)


def apply_precoder(w: CArray, x: CArray) -> CArray:
    """Precode user symbols onto antennas.

    Args:
      w: [S, A, U] planar per-subcarrier precoders.
      x: [U, S] planar user symbols.

    Returns:
      [A, S] planar antenna streams.
    """
    return ceinsum("sau,us->as", w, x)
