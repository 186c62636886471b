"""The one place that picks the receivers' device body.

Every receiver (``UplinkReceiver``, ``StreamingDemodulator`` and their
sharded twins) asks ``choose_body`` which program to trace, so no receiver
reads ``jax.default_backend()`` on its own.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..ops import fft as fft_ops

# 'composed': jnp.fft (cuFFT on the GPU) + the XLA-fused LS/MRC of ops/ls and
#             ops/mrc -- the reference's demodOptimized design, the default.
# 'fast':     the planar DFT-as-GEMM permuted-order path (ops/fastpath) at
#             HIGHEST matmul precision -- an explicit alternative.
PIPELINES = ("composed", "fast")


def choose_body(pipeline: Optional[str] = None,
                fft_impl: Optional[str] = None,
                platform: Optional[str] = None) -> Tuple[str, str]:
    """Return ``(pipeline, fft_impl)`` for ``platform`` (default: JAX's).

    ``pipeline`` defaults to 'composed' and ``fft_impl`` to the platform's
    FFT (``fft.default_impl``).  An unknown platform, pipeline or FFT
    implementation raises ``ValueError``: nothing falls back in silence.
    """
    default_fft = fft_ops.default_impl(platform)
    pipeline = pipeline or "composed"
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}: expected one of "
                         f"{', '.join(PIPELINES)}")
    fft_impl = fft_impl or default_fft
    if fft_impl not in fft_ops.FFT_IMPLS:
        raise ValueError(f"unknown fft_impl {fft_impl!r}: expected one of "
                         f"{', '.join(fft_ops.FFT_IMPLS)}")
    return pipeline, fft_impl
