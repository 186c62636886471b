"""Per-symbol streaming demodulator: the low-latency path.

Mirrors the reference's per-symbol pipeline (firstVector + demodOneSymbol,
gpuLS.cu:351-473; cpuLS_main.cpp:80-93) without its pathologies (plan/alloc
per symbol, device sync per stage, gpuLS.cu:441-452): the per-symbol step is
one jitted program compiled once; symbols stream through as [A, F+cp] planar
blocks; phase timings feed the C14-compatible PhaseTimer.

The demodulator is also the consumer side of the shm ring
(apps/demod_app.py): read symbol -> push -> output row, with the pilot
(slot 0 of each frame) refreshing the channel estimate.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FrameConfig
from ..ops import fft as fft_ops
from ..ops import ls as ls_ops
from ..ops import mrc as mrc_ops
from ..ops.cplx import CArray
from ..ops.modulate import drop_cyclic_prefix, widen_sc16
from ..utils.timing import PhaseTimer
from .body import choose_body

SymbolLike = Union[np.ndarray, CArray]


def _as_carray(x: SymbolLike) -> CArray:
    return x if isinstance(x, CArray) else CArray.from_numpy(x)


def _estimate_symbol_fn(pilot: CArray, x_full: CArray, *, cp: int, fft_impl: str):
    fft = fft_ops.get_fft(fft_impl)
    pilot = widen_sc16(drop_cyclic_prefix(pilot, cp))   # int16 widens in-jit
    return ls_ops.estimate_channel_full(fft(pilot), x_full)


def _demod_symbol_fn(sym: CArray, hconj: CArray, hsqrd: jnp.ndarray,
                     *, cp: int, fft_impl: str) -> CArray:
    fft = fft_ops.get_fft(fft_impl)
    # sc16-native symbols transfer as int16 (half the H2D bytes) and widen
    # on device; float symbols pass through.
    yf = fft(widen_sc16(drop_cyclic_prefix(sym, cp)))   # [A, F]
    eq = mrc_ops.mrc_combine(yf[None], hconj, hsqrd)
    return mrc_ops.finalize(eq)[0]                 # [F-1]


class StreamingDemodulator:
    """Symbol-at-a-time LS+MRC demodulator with a persistent channel estimate.

    Usage:
      sd = StreamingDemodulator(cfg, pilot_x)
      sd.push_pilot(pilot_sym)            # frame start (slot 0)
      out = sd.push_symbol(data_sym)      # [F-1] per data symbol
    """

    def __init__(self, cfg: FrameConfig, pilot_x: np.ndarray,
                 fft_impl: Optional[str] = None,
                 timer: Optional[PhaseTimer] = None):
        """Plain jitted ops (the composed body of ``body.choose_body``) for
        any geometry; ``fft_impl`` defaults to the platform's FFT."""
        cfg.validate()
        _, fft_impl = choose_body(None, fft_impl)
        self.cfg = cfg
        self.fft_impl = fft_impl
        self.x_full = ls_ops.pad_pilot(pilot_x)
        self.timer = timer
        self._hconj: Optional[CArray] = None
        self._hsqrd = None
        kw = dict(cp=cfg.cyclic_prefix, fft_impl=self.fft_impl)
        self._estimate = jax.jit(functools.partial(_estimate_symbol_fn, **kw))
        self._demod = jax.jit(functools.partial(_demod_symbol_fn, **kw))

    @property
    def has_estimate(self) -> bool:
        return self._hconj is not None

    def push_pilot(self, pilot_sym: SymbolLike, slot: int = 0) -> None:
        """Refresh the channel estimate from a frame's pilot symbol [A, F+cp].

        The stored estimate is (hconj, sum|h|^2) in true frequency order."""
        c = _as_carray(pilot_sym)
        if self.timer:
            with self.timer.phase("chanest", slot):
                self._hconj, self._hsqrd = self._estimate(c, self.x_full)
                jax.block_until_ready(self._hsqrd)
        else:
            self._hconj, self._hsqrd = self._estimate(c, self.x_full)

    def push_symbol(self, data_sym: SymbolLike, slot: int = 1) -> CArray:
        """Demod one data symbol [A, F+cp] -> [F-1] with the current estimate.

        ``slot`` is the symbol's frame position (data symbols occupy slots
        1..frame_len-1; slot 0 is the pilot).  PhaseTimer.summary() excludes
        slot 0 from decode stats -- mirroring the reference's &decode[1]
        averaging -- so timed data symbols must not default into it."""
        if self._hconj is None:
            raise RuntimeError("no channel estimate: push_pilot first "
                               "(frame slot 0 is the pilot)")
        c = _as_carray(data_sym)
        if self.timer:
            with self.timer.phase("decode", slot):
                out = self._demod(c, self._hconj, self._hsqrd)
                jax.block_until_ready(out.re)
            return out
        return self._demod(c, self._hconj, self._hsqrd)

    def push_symbol_async(self, data_sym: SymbolLike, slot: int = 1) -> CArray:
        """Dispatch-only variant of push_symbol: enqueues the demod and
        returns immediately without waiting for the device.

        The one-deep streaming pipeline (demod_app._run_per_symbol) uses
        this to overlap the RING READ of symbol k+1 with the device demod
        of symbol k -- the analogue of the reference's per-symbol
        cudaMemcpyAsync streams (ShMemSymBuff_cucomplex.hpp:356-393,
        gpuLS.cu:410-473).  The caller owns the wait; time THAT wait (not
        the dispatch) to keep the decode column honest."""
        if self._hconj is None:
            raise RuntimeError("no channel estimate: push_pilot first "
                               "(frame slot 0 is the pilot)")
        return self._demod(_as_carray(data_sym), self._hconj, self._hsqrd)

    # -- state persistence (checkpoint/resume; io/state.py) ------------------
    def save_state(self, path: str, frame_index: int = 0) -> None:
        """Persist the current channel estimate for restart-resume, in the
        portable true-frequency (hconj, sum|h|^2) layout."""
        if self._hconj is None:
            raise RuntimeError("no channel estimate to save")
        from ..io.state import save_estimate

        save_estimate(path, self.cfg, self._hconj, self._hsqrd, frame_index)

    def resume(self, path: str) -> int:
        """Restore a saved estimate; returns the stored frame index."""
        from ..io.state import load_estimate

        self._hconj, self._hsqrd, idx = load_estimate(path, self.cfg)
        return idx

    def warmup(self, int16: bool = False) -> None:
        """Compile the estimate+demod entries before the ring goes live.

        ``int16=True`` warms the sc16-native traces (planar int16 input):
        jit specializes per input dtype, so the sc16 per-symbol consumer
        warms the trace it will actually run."""
        a, n = self.cfg.num_antennas, self.cfg.symbol_len
        if int16:
            sym = CArray(np.ones((a, n), np.int16), np.zeros((a, n), np.int16))
        else:
            sym = np.ones((a, n), np.complex64)
        self.push_pilot(sym)
        jax.block_until_ready(self.push_symbol(sym).re)
        self._hconj = None
        self._hsqrd = None
