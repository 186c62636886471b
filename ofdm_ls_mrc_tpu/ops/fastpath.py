"""DFT-as-GEMM demod path: transpose-free four-step FFT + LS + MRC.

An explicit alternative to the default composed path (``jnp.fft`` + ops/ls +
ops/mrc), selected with ``pipeline='fast'``.  Three ideas over the naive
GEMM composition (ops/fft.fft_four_step + ops/ls + ops/mrc):

1. **Permuted-order pipeline.**  The four-step FFT's natural output order is
   [k1, k2] (k = N1*k2 + k1).  Instead of transposing back per symbol, the
   whole pipeline -- LS divide, conjugate, |H|^2, MRC -- runs in that
   permuted order (the pilot is pre-permuted once), and ONE gather at the
   edge folds the inverse permutation together with the DC-drop and the
   output ifftshift (shiftOneRow, cpuLS.hpp:368) into a single static take.

2. **Transpose-free einsums.**  Stage 1 uses '...ij,ik->...kj' (contraction
   on the second-minor dim, output layout matching stage 2's input) and
   stage 2 '...jk,jm->...km'; neither needs a layout change.

3. **Karatsuba complex GEMMs.**  Each complex matmul is 3 real GEMMs
   (t1 = (xr+xi) Wr; t2 = xr (Wi-Wr); t3 = xi (Wr+Wi)) instead of 4 --
   a 25% saving on the dominant stage-1 contraction.

Numerics: DFT-matrix combinations (Wi-Wr etc.) are precomputed in fp64 on
the host, so Karatsuba adds no rounding beyond the GEMM passes themselves,
which run at ``fft.PRECISION`` (HIGHEST: no TF32 on the GPU).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .cplx import CArray
from .fft import _split, _twiddle
from .modulate import drop_cyclic_prefix, widen_sc16


def _fast_split(n: int) -> Tuple[int, int]:
    """(n1, n2) with n2 = 128: keeps every intermediate's minor dim 128-wide
    and makes stage 2 a standard minor-dim-contracting GEMM."""
    if n % 128 == 0 and n // 128 >= 2:
        return n // 128, 128
    return _split(n)


@functools.lru_cache(maxsize=None)
def _fast_perm_tables(f: int) -> Tuple[np.ndarray, np.ndarray]:
    """perm/inv between true order and the fast path's [k1, k2] order."""
    n1, n2 = _fast_split(f)
    k1 = np.arange(n1)[:, None]
    k2 = np.arange(n2)[None, :]
    perm = (n1 * k2 + k1).reshape(-1)
    inv = np.empty(f, dtype=np.int32)
    inv[perm] = np.arange(f, dtype=np.int32)
    return perm.astype(np.int32), inv


@functools.lru_cache(maxsize=None)
def _karatsuba_consts(n: int, sign: float):
    """(Wr, Wi-Wr, Wr+Wi) for the n-point DFT matrix, fp64-accurate."""
    k = np.arange(n)
    ang = sign * 2.0 * np.pi * np.outer(k, k) / n
    wr = np.cos(ang)
    wi = np.sin(ang)
    return (wr.astype(np.float32), (wi - wr).astype(np.float32),
            (wr + wi).astype(np.float32))


def _cgemm_kara(xre, xim, consts, spec: str, precision) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Karatsuba complex GEMM: 3 real einsums instead of 4."""
    wr, wi_m_wr, wr_p_wi = (jnp.asarray(c) for c in consts)
    t1 = jnp.einsum(spec, xre + xim, wr, precision=precision)
    t2 = jnp.einsum(spec, xre, wi_m_wr, precision=precision)
    t3 = jnp.einsum(spec, xim, wr_p_wi, precision=precision)
    return t1 - t3, t1 + t2


def stage1_twiddled(x: CArray, precision=None) -> CArray:
    """First four-step stage + twiddle, output [.., k1, i2] flattened to [.., F].

    Natural k1 order; feed to the stage-2 GEMM (fft_permuted's second
    einsum).
    """
    from . import fft as fft_mod

    precision = precision or fft_mod.PRECISION
    n = x.shape[-1]
    n1, n2 = _fast_split(n)
    xs = x.reshape(x.shape[:-1] + (n1, n2))  # [.., i1, i2], minor dim = n2

    # Stage 1: contract i1 (dim -2, size n1 small) -> [.., k1, i2]; output
    # minor dim stays n2 = 128.
    are, aim = _cgemm_kara(xs.re, xs.im, _karatsuba_consts(n1, -1.0),
                           "...ij,ik->...kj", precision)
    # Twiddle in the natural [k1, i2] layout.
    tw = _twiddle(n1, n2, -1.0)  # [k1, i2]
    twre = jnp.asarray(np.ascontiguousarray(tw.real), jnp.float32)
    twim = jnp.asarray(np.ascontiguousarray(tw.imag), jnp.float32)
    bre = are * twre - aim * twim
    bim = are * twim + aim * twre
    return CArray(bre.reshape(x.shape), bim.reshape(x.shape))


def fft_permuted(x: CArray, precision=None) -> CArray:
    """Four-step FFT with output left in [.., k1*N2 + k2] permuted order.

    Input  [..., F]; output [..., F] where position k1*N2+k2 holds true
    frequency N1*k2+k1 under the _fast_split factorization (perm tables in
    _fast_perm_tables).
    """
    from . import fft as fft_mod

    precision = precision or fft_mod.PRECISION
    n = x.shape[-1]
    n1, n2 = _fast_split(n)
    b = stage1_twiddled(x, precision)
    bs = b.reshape(b.shape[:-1] + (n1, n2))
    # Stage 2: contract i2 (the minor dim -- a standard GEMM) -> [.., k1, k2].
    cre, cim = _cgemm_kara(bs.re, bs.im, _karatsuba_consts(n2, -1.0),
                           "...kj,jm->...km", precision)
    return CArray(cre.reshape(x.shape), cim.reshape(x.shape))


@functools.lru_cache(maxsize=None)
def _edge_gather(f: int) -> np.ndarray:
    """One static take fusing inverse-perm + DC-drop + output ifftshift.

    out[j] (reference order, 1023-wide, post-shiftOneRow) = eq_perm[idx[j]].
    True-frequency index before the shift: t = 1 + ((j + (f-1)//2) mod (f-1))
    (ifftshift of the DC-dropped 1023 vector); eq_perm position = inv[t].
    """
    _, inv = _fast_perm_tables(f)
    m = f - 1
    j = np.arange(m)
    t = 1 + (j + m // 2) % m
    return inv[t].astype(np.int32)


def ls_permuted(pilot_spec: CArray, x_perm: CArray) -> Tuple[CArray, jnp.ndarray]:
    """LS channel estimate in permuted frequency order (reference math:
    findHs, gpuLS.cu:158-182, minus the conjugate -- callers fold conj(h)
    into the MRC multiply directly).

    Args:
      pilot_spec: [A, F] (or [A_local, F]) permuted-order pilot spectrum,
                  i.e. fft_permuted output.
      x_perm:     [F] planar padded pilot in permuted order
                  (prepare_pilot_fast).

    Returns:
      (h, hsq): planar estimate [A, F] and sum_a |h|^2 [F].  The DC bin
      needs no masking: x_perm holds 1 at inv[0] and the edge gather never
      reads that position.  This is THE one definition shared by every
      permuted-order pipeline (fast, sharded, streaming).
    """
    denom = 1.0 / x_perm.abs2()
    hre = (pilot_spec.re * x_perm.re + pilot_spec.im * x_perm.im) * denom
    him = (pilot_spec.im * x_perm.re - pilot_spec.re * x_perm.im) * denom
    return CArray(hre, him), jnp.sum(hre * hre + him * him, axis=0)


def demod_frame_fast(frame: CArray, x_full_perm: CArray, *, cp: int,
                     precision=None) -> CArray:
    """Whole-frame demod in permuted frequency order, one edge gather.

    Args:
      frame:        [S, A, F+cp] planar time-domain frame.
      x_full_perm:  [F] planar padded pilot ALREADY in permuted order
                    (see prepare_pilot_fast).

    Returns:
      [S-1, F-1] planar demod output, bit-compatible with the reference
      layout (DC dropped, ifftshift applied).
    """
    y = widen_sc16(drop_cyclic_prefix(frame, cp))
    yf = fft_permuted(y, precision)                  # [S, A, F] permuted
    h, hsqrd = ls_permuted(yf[0], x_full_perm)
    hre, him = h.re, h.im
    data = yf[1:]
    # num = sum_a data * conj(h)
    num_re = jnp.sum(data.re * hre[None] + data.im * him[None], axis=1)
    num_im = jnp.sum(data.im * hre[None] - data.re * him[None], axis=1)
    inv_hs = 1.0 / hsqrd
    eq_re = num_re * inv_hs[None]
    eq_im = num_im * inv_hs[None]
    idx = jnp.asarray(_edge_gather(frame.shape[-1] - cp))
    return CArray(eq_re[:, idx], eq_im[:, idx])


def prepare_pilot_fast(pilot_x: np.ndarray, f: int) -> CArray:
    """Pad the pilot (X[0]=1) and pre-permute it into kernel order."""
    x = np.asarray(pilot_x, dtype=np.complex64)
    full = np.concatenate([np.ones(1, np.complex64), x])
    perm, _ = _fast_perm_tables(f)
    fp = full[perm]
    return CArray(jnp.asarray(fp.real.copy(), jnp.float32),
                  jnp.asarray(fp.imag.copy(), jnp.float32))
