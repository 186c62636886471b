"""FFT-based PN correlation: overlap-save, block-sharded with ppermute.

The reference finds the frame start with an O(N*P) sliding dot product on the
host CPU (rx_and_corr.cpp:332-360).  Here the same correlation --
``corr[i] = sum_j pn[j] * x[i+j]`` (NOT conjugated, matching line 344) -- is
an overlap-save fast convolution: 1024-point FFTs of overlapping blocks (the
platform's FFT, ``fft.default_impl``: cuFFT on the GPU), one elementwise
product with the precomputed kernel spectrum, inverse FFT, overlap discard.
~40x fewer flops than the sliding dot at P = 255.

The sharded variant is the framework's sequence-parallel showcase: the
correlation index axis shards contiguously over the mesh, and each shard
fetches the (P-1)-sample halo it needs from its RIGHT neighbor with ONE
``lax.ppermute`` -- the overlap-state-between-devices pattern called out in
SURVEY.md section 5 for state that crosses time-block boundaries.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .cplx import CArray
from .fft import default_impl, get_fft, get_ifft

_BLOCK_FFT = 1024  # overlap-save FFT size


@functools.lru_cache(maxsize=None)
def _plan(n: int, p: int, f: int = _BLOCK_FFT) -> Tuple[int, int, np.ndarray]:
    """(hop, nblocks, gather_index) for an n-sample, p-chip correlation."""
    hop = f - (p - 1)                     # conv outputs produced per block
    nout = n - p + 1                      # valid correlation lags
    nblocks = -(-nout // hop)
    # Block b reads x[b*hop : b*hop + f]; index -1 marks out-of-range (fill 0).
    idx = (np.arange(nblocks)[:, None] * hop + np.arange(f)[None, :])
    idx = np.where(idx < n, idx, -1)
    return hop, nblocks, idx.astype(np.int32)


def _kernel_spectrum(pn: np.ndarray, f: int = _BLOCK_FFT) -> CArray:
    """FFT of the correlation kernel, host-precomputed in fp64.

    corr = conv(x, g) with g[k] = pn[p-1-k]; overlap-save keeps conv outputs
    [p-1 : f) of each block, which are corr lags [b*hop : b*hop + hop).
    """
    p = pn.shape[0]
    if p > f:
        raise ValueError(f"PN length {p} exceeds block FFT size {f}")
    g = np.zeros(f, np.complex128)
    g[:p] = np.asarray(pn, np.complex128)[::-1]
    gf = np.fft.fft(g).astype(np.complex64)
    return CArray(jnp.asarray(gf.real, jnp.float32),
                  jnp.asarray(gf.imag, jnp.float32))


def pn_correlate(x: CArray, pn: np.ndarray) -> jnp.ndarray:
    """|corr|/P for all N-P+1 lags of an N-sample buffer, jittable.

    Args:
      x:  [N] planar complex received samples.
      pn: [P] complex64 PN sequence (host constant).

    Returns:
      [N-P+1] float32 normalized correlation magnitudes, bit-matching the
      reference's ``abs(corr)/P`` trigger metric (rx_and_corr.cpp:351).
    """
    n = x.shape[-1]
    p = int(pn.shape[0])
    hop, nblocks, idx = _plan(n, p)
    gf = _kernel_spectrum(pn)

    take = functools.partial(jnp.take, indices=jnp.asarray(idx), mode="fill",
                             fill_value=0.0)
    blocks = CArray(take(x.re), take(x.im))            # [nblocks, F]
    impl = default_impl()
    xf = get_fft(impl)(blocks)
    prod = CArray(xf.re * gf.re - xf.im * gf.im,
                  xf.re * gf.im + xf.im * gf.re)
    conv = get_ifft(impl)(prod)                        # unnormalized: F * ifft
    keep = conv[..., p - 1:]                           # [nblocks, hop]
    mags = jnp.sqrt(keep.re ** 2 + keep.im ** 2) / (p * _BLOCK_FFT)
    return mags.reshape(-1)[: n - p + 1]


def pn_correlate_sharded(x: CArray, pn: np.ndarray, mesh, axis) -> jnp.ndarray:
    """Sequence-sharded correlation: lag axis split contiguously over ``axis``.

    Each shard holds a contiguous span of samples and needs the first P-1
    samples of its right neighbor to close its last lags; one ppermute moves
    every shard's head one step left.  The last shard's halo is zeroed (its
    final P-1 lags fall off the end of the buffer and are sliced away).

    Args:
      x:    [N] planar samples, N divisible by the axis size.
      pn:   [P] complex64 PN sequence.
      mesh: jax.sharding.Mesh containing ``axis``.
      axis: mesh axis name to shard the sample/lag axis over.

    Returns:
      [N-P+1] float32 normalized correlation magnitudes (replicated layout
      decided by the caller's jit; computed shard-locally + one ppermute).
    """
    from jax.sharding import PartitionSpec as P_

    p = int(pn.shape[0])
    n = x.shape[-1]
    size = mesh.shape[axis]
    if n % size:
        raise ValueError(f"{n} samples not divisible by {size} shards")
    if n // size < p - 1:
        raise ValueError(
            f"shard length {n // size} < PN halo {p - 1}: use fewer shards "
            "or a longer buffer")

    def local(xs: CArray) -> jnp.ndarray:
        nloc = xs.shape[-1]
        me = jax.lax.axis_index(axis)
        perm = [(i, (i - 1) % size) for i in range(size)]  # head -> left
        halo_re = jax.lax.ppermute(xs.re[: p - 1], axis, perm)
        halo_im = jax.lax.ppermute(xs.im[: p - 1], axis, perm)
        live = (me < size - 1).astype(jnp.float32)
        ext = CArray(jnp.concatenate([xs.re, halo_re * live]),
                     jnp.concatenate([xs.im, halo_im * live]))
        return pn_correlate(ext, pn)                  # [nloc] local lags

    mapped = jax.shard_map(local, mesh=mesh, in_specs=(P_(axis),),
                           out_specs=P_(axis))
    return mapped(x)[: n - p + 1]


def find_frame_start(x: CArray, pn: np.ndarray, thres: float,
                     correlator=pn_correlate) -> Tuple[int, float]:
    """Device-side analogue of sim.pn.correlate_frame_start.

    Returns (index, peak): first lag whose normalized magnitude meets
    ``thres``, or (-1, max_peak) when none does.
    """
    mags = np.asarray(correlator(x, pn))
    hits = np.nonzero(mags >= thres)[0]
    if hits.size == 0:
        return -1, float(mags.max(initial=0.0))
    i = int(hits[0])
    return i, float(mags[i])
