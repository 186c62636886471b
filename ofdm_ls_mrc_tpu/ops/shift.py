"""Half-spectrum swaps as static rolls (XLA-friendly, fuse into neighbors).

The reference implements these as three-memmove swaps on the host
(cpuLS.hpp:105-113,119-149) and as a shared-memory CUDA kernel
(gpuLS.cu:109-125).  Here they are static rolls on the planar components,
which XLA lowers to two slices + concat and fuses into surrounding work.
"""

from __future__ import annotations

from .cplx import CArray


def pilot_shift(x: CArray) -> CArray:
    """fftshift on the last axis (pilot load convention, cpuLS.hpp:105-113)."""
    return x.roll(x.shape[-1] // 2, axis=-1)


def output_shift(x: CArray) -> CArray:
    """ifftshift on the last axis (demod output convention, cpuLS.hpp:135-149)."""
    return x.roll(-(x.shape[-1] // 2), axis=-1)


def tx_shift(x: CArray) -> CArray:
    """ifftshift on the (even) TX grid (cpuLS.hpp:119-132)."""
    return x.roll(-(x.shape[-1] // 2), axis=-1)
