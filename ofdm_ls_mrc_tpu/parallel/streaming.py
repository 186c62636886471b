"""Antenna-sharded per-symbol streaming: the low-latency path on a mesh.

The reference's per-symbol pipeline (firstVector + demodOneSymbol,
gpuLS.cu:351-473) is single-GPU; models/streaming.py is its single-device
form.  This module scales that SAME shape across an ``ant`` mesh axis
for arrays too large for one card: each shard keeps ITS antennas' channel
estimate device-resident, and every data symbol costs exactly one fused
psum of the partial MRC numerator -- 2*F fp32 words, independent of the
antenna count (|H|^2 is reduced once per pilot, not per symbol, so the
steady-state per-symbol collective is smaller than the whole-frame path's
fused (num, |H|^2) payload).

Split-phase collective structure:
  push_pilot:   local FFT + LS  ->  psum(|H|^2)            [1 all-reduce]
  push_symbol:  local FFT + MAC ->  psum(num_re, num_im)   [1 all-reduce]
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import FrameConfig
from ..models.body import choose_body
from ..ops import fastpath
from ..ops import fft as fft_ops
from ..ops import ls as ls_ops
from ..ops import mrc as mrc_ops
from ..ops.cplx import CArray
from ..ops.modulate import drop_cyclic_prefix, widen_sc16
from ..utils.timing import PhaseTimer
from .mesh import ANT_AXIS


# -- composed bodies (plain ops, any geometry) -------------------------------

def _est_local(pilot: CArray, x_full: CArray, *, cp: int, fft_impl: str):
    fft = fft_ops.get_fft(fft_impl)
    # sc16-native shards arrive as int16 and widen in-jit (no-op on float).
    yp = fft(widen_sc16(drop_cyclic_prefix(pilot, cp)))  # [A_l, F]
    hconj, hsq_local = ls_ops.estimate_channel_full(yp, x_full)
    # DC bin is pinned to 1 per shard by estimate_channel_full; the psum
    # makes it n_shards -- still nonzero, and finalize slices it off.
    return hconj, jax.lax.psum(hsq_local, ANT_AXIS)


def _sym_local(sym: CArray, hconj: CArray, hsqrd: jnp.ndarray,
               *, cp: int, fft_impl: str) -> CArray:
    fft = fft_ops.get_fft(fft_impl)
    yf = fft(widen_sc16(drop_cyclic_prefix(sym, cp)))  # [A_l, F]
    num = mrc_ops.mrc_numerator(yf[None], hconj)            # [1, F]
    num_re, num_im = jax.lax.psum((num.re, num.im), ANT_AXIS)
    eq = CArray(num_re, num_im).div_real(hsqrd[None, :])
    return mrc_ops.finalize(eq)[0]                          # [F-1]


# -- fast bodies (permuted-order XLA pipeline) --------------------------------

def _est_local_fast(pilot: CArray, x_perm: CArray, *, cp: int):
    yp = fastpath.fft_permuted(
        widen_sc16(drop_cyclic_prefix(pilot, cp)))
    h, hsq_local = fastpath.ls_permuted(yp, x_perm)
    return h, jax.lax.psum(hsq_local, ANT_AXIS)


def _sym_local_fast(sym: CArray, h: CArray, hsqrd: jnp.ndarray,
                    *, cp: int) -> CArray:
    yd = fastpath.fft_permuted(
        widen_sc16(drop_cyclic_prefix(sym, cp)))    # [A_l, F] perm
    num_re_l = jnp.sum(yd.re * h.re + yd.im * h.im, axis=0)
    num_im_l = jnp.sum(yd.im * h.re - yd.re * h.im, axis=0)
    num_re, num_im = jax.lax.psum((num_re_l, num_im_l), ANT_AXIS)
    inv = 1.0 / hsqrd
    f = sym.shape[-1] - cp
    idx = jnp.asarray(fastpath._edge_gather(f))
    return CArray((num_re * inv)[idx], (num_im * inv)[idx])


class ShardedStreamingDemodulator:
    """Symbol-at-a-time LS+MRC over an antenna-sharded mesh.

    Usage:
      sd = ShardedStreamingDemodulator(cfg, pilot_x, mesh)
      sd.push_pilot(pilot_sym)            # [A, F+cp]; estimate stays sharded
      out = sd.push_symbol(data_sym)      # [F-1] replicated

    The channel estimate lives device-resident, sharded over ``ant`` (each
    shard holds only its antennas' rows); the mesh's ``time`` axis, if any,
    is ignored (replicated) -- per-symbol streaming has no time batch.
    """

    def __init__(self, cfg: FrameConfig, pilot_x: np.ndarray, mesh: Mesh,
                 fft_impl: Optional[str] = None,
                 timer: Optional[PhaseTimer] = None,
                 pipeline: Optional[str] = None):
        """pipeline: 'composed' (default; plain ops) or 'fast'
        (permuted-order DFT-as-GEMM); see ``body.choose_body``."""
        cfg.validate()
        pipeline, fft_impl = choose_body(pipeline, fft_impl)
        if pilot_x.shape[-1] != cfg.num_subcarriers:
            raise ValueError(
                f"pilot has {pilot_x.shape[-1]} bins, config wants "
                f"{cfg.num_subcarriers}")
        n_ant = mesh.shape[ANT_AXIS]
        if cfg.num_antennas % n_ant:
            raise ValueError(f"{cfg.num_antennas} antennas not divisible by "
                             f"{n_ant} ant shards")
        self.cfg = cfg
        self.mesh = mesh
        self.fft_impl = fft_impl
        self.pipeline = pipeline
        self.timer = timer
        self._hconj: Optional[CArray] = None
        self._hsqrd = None

        cp = cfg.cyclic_prefix
        if pipeline == "composed":
            est = functools.partial(_est_local, cp=cp, fft_impl=self.fft_impl)
            sym = functools.partial(_sym_local, cp=cp, fft_impl=self.fft_impl)
            self.x_ref = ls_ops.pad_pilot(pilot_x)
        else:
            est = functools.partial(_est_local_fast, cp=cp)
            sym = functools.partial(_sym_local_fast, cp=cp)
            self.x_ref = fastpath.prepare_pilot_fast(pilot_x, cfg.fft_size)

        self._estimate = jax.jit(jax.shard_map(
            est, mesh=mesh,
            in_specs=(P(ANT_AXIS, None), P()),
            out_specs=(P(ANT_AXIS, None), P()),
        ))
        self._demod = jax.jit(jax.shard_map(
            sym, mesh=mesh,
            in_specs=(P(ANT_AXIS, None), P(ANT_AXIS, None), P()),
            out_specs=P(),
        ))

    @property
    def has_estimate(self) -> bool:
        return self._hconj is not None

    def push_pilot(self, pilot_sym, slot: int = 0) -> None:
        """Refresh the estimate from a frame's pilot symbol [A, F+cp]; one
        psum carries |H|^2 (the numerator's share of the reference's fused
        payload moves to the per-symbol step)."""
        c = pilot_sym if isinstance(pilot_sym, CArray) else CArray.from_numpy(
            np.asarray(pilot_sym))
        if self.timer:
            with self.timer.phase("chanest", slot):
                self._hconj, self._hsqrd = self._estimate(c, self.x_ref)
                jax.block_until_ready(self._hsqrd)
        else:
            self._hconj, self._hsqrd = self._estimate(c, self.x_ref)

    def push_symbol(self, data_sym, slot: int = 1) -> CArray:
        """Demod one data symbol [A, F+cp] -> [F-1] (replicated); exactly one
        all-reduce of 2*F fp32 words rides the ant axis."""
        if self._hconj is None:
            raise RuntimeError("no channel estimate: push_pilot first "
                               "(frame slot 0 is the pilot)")
        c = data_sym if isinstance(data_sym, CArray) else CArray.from_numpy(
            np.asarray(data_sym))
        if self.timer:
            with self.timer.phase("decode", slot):
                out = self._demod(c, self._hconj, self._hsqrd)
                jax.block_until_ready(out.re)
            return out
        return self._demod(c, self._hconj, self._hsqrd)

    def push_symbol_async(self, data_sym, slot: int = 1) -> CArray:
        """Dispatch-only push_symbol (the one-deep overlap pipeline; the
        caller owns -- and should time -- the wait)."""
        if self._hconj is None:
            raise RuntimeError("no channel estimate: push_pilot first "
                               "(frame slot 0 is the pilot)")
        c = data_sym if isinstance(data_sym, CArray) else CArray.from_numpy(
            np.asarray(data_sym))
        return self._demod(c, self._hconj, self._hsqrd)

    def warmup(self, int16: bool = False) -> None:
        """Compile both programs at the live shapes (the live-app warm-up;
        the reference's one-time cuFFT plan warm-up, gpuLS_main.cu:94-97).
        ``int16=True`` warms the sc16-native (planar int16 input) traces."""
        a, n = self.cfg.num_antennas, self.cfg.symbol_len
        if int16:
            sym = CArray(np.ones((a, n), np.int16), np.zeros((a, n), np.int16))
        else:
            sym = np.ones((a, n), np.complex64)
        self.push_pilot(sym)
        jax.block_until_ready(self.push_symbol(sym).re)
        self._hconj = None
        self._hsqrd = None

    # -- state persistence (checkpoint/resume; io/state.py) ------------------
    # The portable layout is true-frequency (hconj, sum|h|^2), identical to
    # StreamingDemodulator's, so checkpoints move freely between sharded and
    # unsharded consumers and across pipelines.  Gathering/scattering the
    # ant-sharded estimate is host-side (single-process meshes).

    def _perm_tables(self):
        from ..ops.fastpath import _fast_perm_tables
        return _fast_perm_tables(self.cfg.fft_size)

    def save_state(self, path: str, frame_index: int = 0) -> None:
        if self._hconj is None:
            raise RuntimeError("no channel estimate to save")
        if jax.process_count() > 1:
            raise RuntimeError("save_state gathers the sharded estimate on "
                               "one host; multi-process runs checkpoint per "
                               "time-block via the whole-frame consumer")
        from ..io.state import save_estimate

        h = CArray(np.asarray(self._hconj.re), np.asarray(self._hconj.im))
        hsq = np.asarray(self._hsqrd)
        if self.pipeline == "composed":
            save_estimate(path, self.cfg, h, hsq, frame_index)
        else:
            _, inv = self._perm_tables()
            hconj = CArray(h.re[:, inv], -h.im[:, inv])
            save_estimate(path, self.cfg, hconj, hsq[inv], frame_index)

    def resume(self, path: str) -> int:
        if jax.process_count() > 1:
            # Mirror save_state's guard: device_put to a mesh spanning other
            # processes' devices fails with an opaque sharding error.
            raise RuntimeError("resume scatters a host-side estimate onto "
                               "this mesh; multi-process runs checkpoint per "
                               "time-block via the whole-frame consumer")
        from ..io.state import load_estimate

        hconj, hsqrd, idx = load_estimate(path, self.cfg)
        if self.pipeline == "composed":
            hre = np.asarray(hconj.re)
            him = np.asarray(hconj.im)
            hsq = np.asarray(hsqrd)
        else:
            perm, _ = self._perm_tables()
            # Stored hconj -> pipeline-native h (un-conjugated, perm order).
            hre = np.asarray(hconj.re)[:, perm]
            him = -np.asarray(hconj.im)[:, perm]
            hsq = np.asarray(hsqrd)[perm]
        from jax.sharding import NamedSharding

        hsh = NamedSharding(self.mesh, P(ANT_AXIS, None))
        self._hconj = CArray(jax.device_put(hre, hsh),
                             jax.device_put(him, hsh))
        self._hsqrd = jax.device_put(hsq, NamedSharding(self.mesh, P()))
        return idx
