"""Batched FFTs for the OFDM pipeline over planar ``CArray`` tensors.

The reference re-creates FFTW plans per call (cpuLS.hpp:165-174) and cuFFT
plans per symbol (gpuLS.cu:441-445).  Here every FFT is a traced jitted op
over the whole ``[symbols, antennas, fft]`` batch:

* ``xla``       -- ``jnp.fft`` on complex64: cuFFT on the GPU, XLA's own FFT
                   on the CPU.  The default on every supported platform.
* ``matmul``    -- one dense DFT as 4 real GEMMs (explicit option).
* ``four_step`` -- Cooley-Tukey N = N1*N2: two small GEMM groups plus a
                   planar twiddle multiply; O(N*(N1+N2)) FLOPs (explicit
                   option).

All paths compute the unnormalized forward DFT (== FFTW_FORWARD == np.fft.fft);
inverses are the unnormalized backward DFT (== FFTW_BACKWARD == np.fft.ifft*N,
cpuLS.hpp:152-162).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .cplx import CArray, ceinsum, cmatmul, from_const

# Matmul precision for the DFT-as-GEMM stages.  On the GPU a float32 matmul
# at any lower precision may run in TF32 (about three decimal digits), which
# would break the receiver's fp32-grade contract against golden/dsp.py.
PRECISION = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _dft_matrix(n: int, sign: float) -> np.ndarray:
    k = np.arange(n)
    return np.exp(sign * 2j * np.pi * np.outer(k, k) / n).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _twiddle(n1: int, n2: int, sign: float) -> np.ndarray:
    k1 = np.arange(n1)[:, None]
    i2 = np.arange(n2)[None, :]
    return np.exp(sign * 2j * np.pi * k1 * i2 / (n1 * n2)).astype(np.complex64)


def _split(n: int) -> tuple[int, int]:
    """Factor n = n1*n2 for the four-step decomposition.

    Prefers n1 = 128 whenever n divides (a 128-wide first-stage contraction
    keeps each GEMM large); falls back to the balanced split for small n.
    """
    if n % 128 == 0 and n // 128 >= 2:
        return 128, n // 128
    n1 = 1 << ((n.bit_length() - 1 + 1) // 2)
    while n % n1:
        n1 >>= 1
    return max(n1, n // n1), min(n1, n // n1)


# ---------------------------------------------------------------------------
# DFT-as-GEMM implementations
# ---------------------------------------------------------------------------

def fft_matmul(x: CArray, sign: float = -1.0) -> CArray:
    """Dense DFT as planar matmul: X = x @ W, W[n,k] = exp(sign*2pi i nk/N)."""
    n = x.shape[-1]
    w = from_const(_dft_matrix(n, sign))
    return cmatmul(x, w, precision=PRECISION)


def ifft_matmul(x: CArray) -> CArray:
    return fft_matmul(x, sign=1.0)


def fft_four_step(x: CArray, sign: float = -1.0) -> CArray:
    """Four-step Cooley-Tukey FFT, planar, as two GEMM stages.

    With n = n1*n2, input index n = n2*i1 + i2 and output k = n1*k2 + k1:
      A[.., k1, i2] = sum_i1 x[.., i1, i2] W_{n1}^{i1 k1}     (GEMM over i1)
      B             = A * W_n^{k1 i2}                          (twiddle)
      C[.., k1, k2] = sum_i2 B[.., k1, i2] W_{n2}^{i2 k2}     (GEMM over i2)
      out[.., n1*k2 + k1] = C[.., k1, k2]
    """
    n = x.shape[-1]
    n1, n2 = _split(n)
    if n2 == 1:
        return fft_matmul(x, sign)
    d1 = from_const(_dft_matrix(n1, sign))
    d2 = from_const(_dft_matrix(n2, sign))
    tw = from_const(_twiddle(n1, n2, sign))
    xs = x.reshape(x.shape[:-1] + (n1, n2))

    def stage(a: CArray, d: CArray, spec: str) -> CArray:
        return ceinsum(spec, a, d, precision=PRECISION)

    a = stage(xs, d1, "...ij,ik->...kj")   # contract over i1 -> [.., k1, i2]
    b = a * tw                              # planar twiddle
    c = stage(b, d2, "...kj,jm->...km")     # contract over i2 -> [.., k1, k2]
    return c.swapaxes(-1, -2).reshape(x.shape)


def ifft_four_step(x: CArray) -> CArray:
    return fft_four_step(x, sign=1.0)


# ---------------------------------------------------------------------------
# Complex-dtype implementation (cuFFT on the GPU; the default)
# ---------------------------------------------------------------------------

def fft_xla(x: CArray) -> CArray:
    """jnp.fft.fft on complex64 (float planes; widen sc16 first)."""
    xc = jax.lax.complex(x.re, x.im)
    y = jnp.fft.fft(xc, axis=-1)
    return CArray(jnp.real(y).astype(jnp.float32), jnp.imag(y).astype(jnp.float32))


def ifft_xla(x: CArray) -> CArray:
    xc = jax.lax.complex(x.re, x.im)
    y = jnp.fft.ifft(xc, axis=-1) * x.shape[-1]
    return CArray(jnp.real(y).astype(jnp.float32), jnp.imag(y).astype(jnp.float32))


FFT_IMPLS: dict[str, Callable[[CArray], CArray]] = {
    "xla": fft_xla,
    "matmul": fft_matmul,
    "four_step": fft_four_step,
}

IFFT_IMPLS: dict[str, Callable[[CArray], CArray]] = {
    "xla": ifft_xla,
    "matmul": ifft_matmul,
    "four_step": ifft_four_step,
}


def get_fft(impl: str = "four_step") -> Callable[[CArray], CArray]:
    return FFT_IMPLS[impl]


def get_ifft(impl: str = "four_step") -> Callable[[CArray], CArray]:
    return IFFT_IMPLS[impl]


PLATFORMS = ("cpu", "gpu")


def default_impl(platform: str | None = None) -> str:
    """The FFT implementation for ``platform`` (default: JAX's backend).

    ``jnp.fft`` everywhere the receiver runs; a platform without a tested
    device path is an error, never a silent fallback."""
    platform = platform or jax.default_backend()
    if platform not in PLATFORMS:
        raise ValueError(f"no device path for platform {platform!r}; "
                         f"supported: {', '.join(PLATFORMS)}")
    return "xla"
