"""Uplink receiver: the flagship frame pipeline.

The reference's five GPU strategies (per-symbol ``demodOneSymbol``,
whole-frame ``demodOneFrame``/``demodOneFrameCUDA``, occupancy-tuned
``demodOptimized``, and ``demodCuBlas`` -- gpuLS.cu:410-858) collapse into
ONE jitted pure function over a planar ``[symbols, antennas, fft]`` tensor:
one batched FFT (cuFFT on the GPU) over every row, then XLA fuses the LS
divide, conjugate, MRC multiply-reduce over antennas and normalize -- the
``demodOptimized`` design, with no per-symbol plans, allocs, or syncs (the
reference re-creates a cuFFT plan and cudaMallocs per symbol,
gpuLS.cu:441-452).

sc16 frames (planar int16) are widened to float32 inside the jitted program,
so the host-to-device copy carries int16 bytes.

A per-symbol streaming mode (models/streaming.py) covers the low-latency path.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FrameConfig
from ..ops import fastpath
from ..ops import fft as fft_ops
from ..ops import ls as ls_ops
from ..ops import mrc as mrc_ops
from ..ops.cplx import CArray
from ..ops.modulate import drop_cyclic_prefix, widen_sc16
from .body import choose_body

FrameLike = Union[np.ndarray, CArray]


def _as_carray(x: FrameLike) -> CArray:
    return x if isinstance(x, CArray) else CArray.from_numpy(x)


def demod_frame_fn(frame: CArray, x_full: CArray, *, cp: int,
                   fft_impl: str) -> CArray:
    """Whole-frame demod: symbol 0 is the pilot, the rest are data.

    Args:
      frame:  [S, A, F+cp] planar time-domain frame (float32 or sc16 int16).
      x_full: [F] planar padded pilot (ls.pad_pilot output).

    Returns:
      [S-1, F-1] planar demodulated data (reference output layout).
    """
    fft = fft_ops.get_fft(fft_impl)
    yf = fft(widen_sc16(drop_cyclic_prefix(frame, cp)))   # [S, A, F]
    hconj, hsqrd = ls_ops.estimate_channel_full(yf[0], x_full)
    eq = mrc_ops.mrc_combine(yf[1:], hconj, hsqrd)  # [S-1, F]
    return mrc_ops.finalize(eq)


def estimate_fn(pilot_sym: CArray, x_full: CArray, *, cp: int, fft_impl: str):
    fft = fft_ops.get_fft(fft_impl)
    y = widen_sc16(drop_cyclic_prefix(pilot_sym, cp))
    return ls_ops.estimate_channel_full(fft(y), x_full)


def demod_data_fn(data: CArray, hconj: CArray, hsqrd: jnp.ndarray,
                  *, cp: int, fft_impl: str) -> CArray:
    """Demod pre-estimated data symbols: [S, A, F+cp] -> [S, F-1]."""
    fft = fft_ops.get_fft(fft_impl)
    y = widen_sc16(drop_cyclic_prefix(data, cp))
    eq = mrc_ops.mrc_combine(fft(y), hconj, hsqrd)
    return mrc_ops.finalize(eq)


class UplinkReceiver:
    """LS + MRC uplink receiver for one antenna-array stream.

    Usage:
      rx = UplinkReceiver(cfg, pilot_x)
      out = rx.demod_frame(frame)            # complex64 [S-1, F-1]
      h = rx.estimate_channel(frame[0])      # split-phase variant
      out = rx.demod_data(frame[1:], *h)

    Inputs may be host complex64 arrays or device-resident planar CArrays;
    outputs are CArrays (call ``.to_numpy()`` for host complex64).
    """

    def __init__(self, cfg: FrameConfig, pilot_x: np.ndarray,
                 fft_impl: Optional[str] = None, donate: bool = False,
                 pipeline: Optional[str] = None):
        """pipeline: 'composed' (default; ``jnp.fft`` + XLA-fused LS/MRC) or
        'fast' (the DFT-as-GEMM permuted-order path, ops/fastpath); see
        ``body.choose_body``.  The split-phase estimate/demod_data API always
        uses the composed ops (its estimates are interchangeable across
        frames)."""
        cfg.validate()
        pipeline, fft_impl = choose_body(pipeline, fft_impl)
        if pilot_x.shape[-1] != cfg.num_subcarriers:
            raise ValueError(
                f"pilot has {pilot_x.shape[-1]} bins, config wants {cfg.num_subcarriers}")
        self.cfg = cfg
        self.fft_impl = fft_impl
        self.pipeline = pipeline
        self.x_full = ls_ops.pad_pilot(pilot_x)

        # Donation is off by default: every output here is strictly smaller
        # than its inputs ([S-1, F-1] vs [S, A, F+cp]) so XLA can never reuse
        # a donated buffer -- it only emits warnings.
        kw = dict(cp=cfg.cyclic_prefix, fft_impl=self.fft_impl)
        donate_args = (0,) if donate else ()
        if pipeline == "fast":
            x_perm = fastpath.prepare_pilot_fast(pilot_x, cfg.fft_size)
            self._demod_frame = jax.jit(functools.partial(
                fastpath.demod_frame_fast, x_full_perm=x_perm,
                cp=cfg.cyclic_prefix), donate_argnums=donate_args)
        else:
            self._demod_frame = jax.jit(
                functools.partial(demod_frame_fn, x_full=self.x_full, **kw),
                donate_argnums=donate_args)
        self._demod_capture = None  # built lazily by demod_capture
        self._estimate = jax.jit(functools.partial(estimate_fn, **kw))
        self._demod_data = jax.jit(
            functools.partial(demod_data_fn, **kw), donate_argnums=donate_args)

    # -- whole-frame path (analog of demodOptimized, gpuLS.cu:677-769) ------
    def demod_frame(self, frame: FrameLike) -> CArray:
        """[S, A, F+cp] -> [S-1, F-1] demodulated data symbols."""
        return self._demod_frame(_as_carray(frame))

    # -- split-phase path (analog of firstVector + demodOneSymbol) ----------
    def estimate_channel(self, pilot_sym: FrameLike) -> Tuple[CArray, jax.Array]:
        """[A, F+cp] pilot -> (hconj [A, F], hsqrd [F]) on the full grid."""
        return self._estimate(_as_carray(pilot_sym), self.x_full)

    def demod_data(self, data: FrameLike, hconj: CArray, hsqrd) -> CArray:
        """[S, A, F+cp] data + estimates -> [S, F-1]."""
        return self._demod_data(_as_carray(data), hconj, hsqrd)

    # -- long-capture path: many frames in one dispatch ---------------------
    def demod_capture(self, frames: FrameLike) -> CArray:
        """[K, S, A, F+cp] capture (K whole frames) -> [K, S-1, F-1].

        One jitted ``lax.scan`` over device-resident frames: a single
        dispatch per capture instead of per frame, the pattern the reference
        approximates with its ``numTimes`` outer loop (cpuLS_main.cpp:80-93)
        re-entering the driver per frame.
        """
        if self._demod_capture is None:
            demod_one = self._demod_frame

            def capture(frs: CArray) -> CArray:
                def body(_, x):
                    return None, demod_one(x)
                _, out = jax.lax.scan(body, None, frs)
                return out

            self._demod_capture = jax.jit(capture)
        return self._demod_capture(_as_carray(frames))

    # -- compile ahead of time ----------------------------------------------
    def warmup(self) -> None:
        """Compile both paths on zeros (the reference 'warm-up' FFT,
        gpuLS_main.cu:94-97, done properly: once, cached thereafter)."""
        s, a = self.cfg.frame_len, self.cfg.num_antennas
        n = self.cfg.symbol_len
        frame = np.ones((s, a, n), np.complex64)
        jax.block_until_ready(self.demod_frame(frame).re)
        h = self.estimate_channel(np.ones((a, n), np.complex64))
        jax.block_until_ready(
            self.demod_data(np.ones((s - 1, a, n), np.complex64), *h).re)
