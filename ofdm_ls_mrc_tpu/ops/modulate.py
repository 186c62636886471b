"""OFDM modulation (TX side) as jitted planar batch ops.

Math per reference ``modOneSymbol``/``modRefSymbol``/``addPrefix``
(cpuLS.hpp:466-529,391-398): place F-1 data bins at grid offset 1, ifftshift,
unnormalized IFFT (FFTW_BACKWARD), scale each row by 1/max|.| (LAPACK clange
'M' + csscal), prepend the symbol tail as cyclic prefix.
"""

from __future__ import annotations

import jax.numpy as jnp

from .cplx import CArray, cconcat, czeros
from .fft import get_ifft
from .shift import tx_shift


def add_cyclic_prefix(sym: CArray, cp: int) -> CArray:
    """Prepend the last ``cp`` samples (addPrefix, cpuLS.hpp:391-398)."""
    if cp == 0:
        return sym
    return cconcat([sym[..., -cp:], sym], axis=-1)


def drop_cyclic_prefix(sym: CArray, cp: int) -> CArray:
    """Strip the cyclic prefix (read path, ShMemSymBuff.hpp:281-294)."""
    if cp == 0:
        return sym
    return sym[..., cp:]


def widen_sc16(x: CArray) -> CArray:
    """Planar int16 (sc16 wire format) -> full-scale float32; float planes
    pass through.

    Called inside the jitted bodies, so the host-to-device copy stays at
    int16 bytes and the FFT sees float32."""
    if jnp.issubdtype(jnp.result_type(x.re), jnp.integer):
        from ..golden.io import SC16_FULL_SCALE
        return CArray(x.re.astype(jnp.float32) / SC16_FULL_SCALE,
                      x.im.astype(jnp.float32) / SC16_FULL_SCALE)
    return x


def modulate(data: CArray, cp: int = 0, impl: str = "four_step") -> CArray:
    """Batch OFDM modulator, faithful to modOneSymbol (cpuLS.hpp:492-529).

    Args:
      data: [..., F-1] planar subcarrier values.
      cp:   cyclic prefix length.
      impl: IFFT implementation key (see ops.fft).

    Returns:
      [..., F+cp] planar time-domain symbols, each max-abs normalized.
    """
    zeros = czeros(data.shape[:-1] + (1,))
    grid = cconcat([zeros, data], axis=-1)
    td = get_ifft(impl)(tx_shift(grid))
    maxabs = jnp.sqrt(jnp.max(td.abs2(), axis=-1, keepdims=True))
    td = td.div_real(maxabs)
    return add_cyclic_prefix(td, cp)


def modulate_frame_matched(data: CArray, pilot_x: CArray, cp: int = 0,
                           impl: str = "four_step") -> CArray:
    """Receiver-matched frame modulator (see sim.channel.make_tx_frame).

    Places pilot + data directly on FFT bins 1..F-1 with one frame-wide scale,
    so estimate -> demod recovers ``data`` exactly through a CP-covered channel.

    Args:
      data:    [S-1, F-1] planar subcarrier data.
      pilot_x: [F-1] planar pilot (post pilot_shift).

    Returns:
      [S, F+cp] planar time-domain frame.
    """
    f = pilot_x.shape[-1] + 1
    s = data.shape[0] + 1
    zeros_col = czeros((s, 1))
    rows = cconcat([pilot_x.reshape(1, -1), data], axis=0)
    grid = cconcat([zeros_col, rows], axis=-1)
    td = get_ifft(impl)(grid) * (1.0 / f)
    scale = 1.0 / jnp.sqrt(jnp.max(td.abs2()))
    td = td * scale
    return add_cyclic_prefix(td, cp)
