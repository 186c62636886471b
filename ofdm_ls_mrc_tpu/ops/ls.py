"""Least-Squares channel estimation on full-width (DC-masked) planar tensors.

Layout decision: the reference drops the DC bin immediately, making every
hot tensor 1023 wide (gpuLS.cuh:67-70).  Here all hot ops run on the full
``fft_size`` grid with the DC bin masked
(hconj[...,0] = 0, hsqrd[0] = 1), and the 1023-wide view is sliced only at
the pipeline edge (see ``finalize`` in mrc.py).

Math per reference ``firstVector`` (cpuLS.hpp:247-317) / ``findHs``
(gpuLS.cu:158-182): H = FFT(pilot)[1:] / X, conjugated; Hsqrd = sum_ant |H|^2
(findDistSqrd, cpuLS.hpp:211-228, gpuLS.cu:185-209).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from .cplx import CArray, cdiv, cwhere, from_const


def pad_pilot(pilot_x: np.ndarray) -> CArray:
    """Embed the (F-1)-wide pilot into the full FFT grid with X[0] = 1.

    The DC slot's value is arbitrary (masked downstream); 1 avoids a
    divide-by-zero without branching.  Returns a planar constant.
    """
    x = np.asarray(pilot_x, dtype=np.complex64)
    full = np.concatenate([np.ones(x.shape[:-1] + (1,), np.complex64), x], axis=-1)
    return from_const(full)


def estimate_channel_full(pilot_fft: CArray, x_full: CArray) -> Tuple[CArray, jnp.ndarray]:
    """LS estimate on the full grid from an already-FFT'd pilot symbol.

    Args:
      pilot_fft: [A, F] planar, FFT of the time-domain pilot rows.
      x_full:    [F] planar padded pilot (pad_pilot output).

    Returns:
      hconj_full: [A, F] planar conj(H) with the DC bin zeroed.
      hsqrd_full: [F] float32 sum_ant |H|^2 with the DC bin set to 1.
    """
    h = cdiv(pilot_fft, x_full)
    f = h.shape[-1]
    dc_mask = jnp.arange(f) != 0
    hconj = cwhere(dc_mask, h.conj(), 0.0)
    hsqrd = jnp.sum(h.abs2(), axis=0)
    hsqrd = jnp.where(dc_mask, hsqrd, jnp.ones((), hsqrd.dtype))
    return hconj, hsqrd
