"""Sharded uplink pipeline: antenna-sharded MRC with one psum, time-sharded
symbol blocks.

This replaces the reference's intra-GPU reductions (shared-memory tree sums
over antennas, gpuLS.cu:198-203,247-252) with XLA collectives over a device
mesh: each ``ant`` shard FFTs its local antennas, forms its local LS estimate
and partial MRC numerator, and a single fused ``psum`` over the ``ant`` axis
combines (numerator_re, numerator_im, |H|^2) in one reduced payload -- the
"combined payload" design from SURVEY.md section 7 that halves the
collective count vs reducing numerator and denominator separately.  On
several GPUs XLA hands that psum to NCCL.

The ``time`` axis is collective-free data parallelism over symbol blocks.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import FrameConfig
from ..ops import fastpath
from ..ops import fft as fft_ops
from ..ops import ls as ls_ops
from ..ops import mrc as mrc_ops
from ..ops.cplx import CArray
from ..models.body import choose_body
from ..ops.modulate import drop_cyclic_prefix, widen_sc16
from .mesh import ANT_AXIS, TIME_AXIS, frame_sharding, pilot_sharding


def _sharded_demod_local(pilot: CArray, data: CArray, x_full: CArray,
                         *, cp: int, fft_impl: str) -> CArray:
    """Per-shard body run under shard_map.

    Args (local shard views; float32 or sc16 int16 planes):
      pilot:  [A_local, F+cp]
      data:   [S_local, A_local, F+cp]
      x_full: [F] (replicated)

    Returns:
      [S_local, F-1] demodulated block, replicated over ``ant``.
    """
    fft = fft_ops.get_fft(fft_impl)
    yp = fft(widen_sc16(drop_cyclic_prefix(pilot, cp)))   # [A_l, F]
    hconj, hsqrd_local = ls_ops.estimate_channel_full(yp, x_full)

    yd = fft(widen_sc16(drop_cyclic_prefix(data, cp)))    # [S_l, A_l, F]
    num_local = mrc_ops.mrc_numerator(yd, hconj)       # [S_l, F]

    # One fused all-reduce over the antenna mesh axis: numerator (re, im)
    # and |H|^2 ride the same psum payload.
    num_re, num_im, hsqrd = jax.lax.psum(
        (num_local.re, num_local.im, hsqrd_local), ANT_AXIS)
    # estimate_channel_full pins the masked DC bin of hsqrd to 1 per shard;
    # after the psum it is n_ant_shards -- still nonzero, and the DC bin is
    # sliced off in finalize, so no correction is needed.
    eq = CArray(num_re, num_im).div_real(hsqrd[None, :])
    return mrc_ops.finalize(eq)


def _sharded_demod_local_fast(pilot: CArray, data: CArray, x_perm: CArray,
                              *, cp: int) -> CArray:
    """Fast-path shard body: permuted-order FFT+LS+MRC with one fused psum.

    Identical collective structure to _sharded_demod_local but runs the
    transpose-free permuted-order pipeline (ops/fastpath) per shard; the
    edge gather to reference order happens after the psum.
    """
    yp = fastpath.fft_permuted(widen_sc16(drop_cyclic_prefix(pilot, cp)))
    h, hsq_local = fastpath.ls_permuted(yp, x_perm)              # perm order
    hre, him = h.re, h.im

    yd = fastpath.fft_permuted(widen_sc16(drop_cyclic_prefix(data, cp)))
    num_re_l = jnp.sum(yd.re * hre[None] + yd.im * him[None], axis=1)
    num_im_l = jnp.sum(yd.im * hre[None] - yd.re * him[None], axis=1)

    num_re, num_im, hsqrd = jax.lax.psum((num_re_l, num_im_l, hsq_local),
                                         ANT_AXIS)
    inv = 1.0 / hsqrd
    f = data.shape[-1] - cp
    idx = jnp.asarray(fastpath._edge_gather(f))
    return CArray((num_re * inv[None])[:, idx], (num_im * inv[None])[:, idx])


class ShardedUplinkReceiver:
    """Uplink receiver sharded over an (ant, time) mesh.

    The pilot symbol is antenna-sharded; data symbols are sharded over both
    antennas and time-blocks.  Output is time-sharded, antenna-replicated.

    Usage:
      mesh = make_mesh(ant_shards=4, time_shards=2)
      rx = ShardedUplinkReceiver(cfg, pilot_x, mesh)
      out = rx.demod_frame(frame)   # frame [S, A, F+cp], S-1 divisible by time
    """

    def __init__(self, cfg: FrameConfig, pilot_x: np.ndarray, mesh: Mesh,
                 fft_impl: Optional[str] = None,
                 pipeline: Optional[str] = None):
        """pipeline: 'composed' (default) or 'fast' shard body; see
        ``body.choose_body``."""
        cfg.validate()
        pipeline, fft_impl = choose_body(pipeline, fft_impl)
        if pilot_x.shape[-1] != cfg.num_subcarriers:
            raise ValueError(
                f"pilot has {pilot_x.shape[-1]} bins, config wants "
                f"{cfg.num_subcarriers}")
        self.cfg = cfg
        self.mesh = mesh
        self.fft_impl = fft_impl
        self.pipeline = pipeline
        self.x_full = (fastpath.prepare_pilot_fast(pilot_x, cfg.fft_size)
                       if pipeline == "fast" else ls_ops.pad_pilot(pilot_x))

        n_ant = mesh.shape[ANT_AXIS]
        n_time = mesh.shape[TIME_AXIS]
        if cfg.num_antennas % n_ant:
            raise ValueError(f"{cfg.num_antennas} antennas not divisible by "
                             f"{n_ant} ant shards")
        if cfg.num_data_symbols % n_time:
            raise ValueError(f"{cfg.num_data_symbols} data symbols not divisible "
                             f"by {n_time} time shards")

        if pipeline == "fast":
            body = functools.partial(_sharded_demod_local_fast,
                                     cp=cfg.cyclic_prefix)
        else:
            body = functools.partial(
                _sharded_demod_local, cp=cfg.cyclic_prefix,
                fft_impl=self.fft_impl)
        mapped = jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(ANT_AXIS, None),             # pilot [A, N]
                      P(TIME_AXIS, ANT_AXIS, None),  # data  [S-1, A, N]
                      P()),                          # x_full replicated
            out_specs=P(TIME_AXIS, None),            # out   [S-1, F-1]
        )
        self._demod = jax.jit(mapped)
        self._demod_capture = None  # built lazily by demod_capture

    def demod_frame(self, frame) -> CArray:
        """[S, A, F+cp] (host complex64 or planar CArray) -> [S-1, F-1]."""
        c = frame if isinstance(frame, CArray) else CArray.from_numpy(frame)
        return self._demod(c[0], c[1:], self.x_full)

    def demod_capture(self, frames) -> CArray:
        """[K, S, A, F+cp] capture -> [K, S-1, F-1], one dispatch.

        A jitted ``lax.scan`` over whole frames of the sharded step: each
        frame's pilot refreshes the estimate, time-blocks stay sharded over
        the mesh, and the host re-enters only once per capture.
        """
        if self._demod_capture is None:
            demod = self._demod

            def capture(frs: CArray, xf) -> CArray:
                def body(_, x):
                    return None, demod(x[0], x[1:], xf)
                _, out = jax.lax.scan(body, None, frs)
                return out

            self._demod_capture = jax.jit(capture)
        c = frames if isinstance(frames, CArray) else CArray.from_numpy(frames)
        return self._demod_capture(c, self.x_full)

    def demod_pilot_data(self, pilot: CArray, data: CArray) -> CArray:
        """Pre-split, possibly device-resident inputs: pilot [A, N], data
        [S-1, A, N]."""
        return self._demod(pilot, data, self.x_full)

    def place(self, frame: np.ndarray) -> Tuple[CArray, CArray]:
        """Host frame -> device-placed (pilot, data) with the mesh shardings.

        Placing inputs explicitly avoids a lazy re-shard on first call and is
        the fast path for the streaming feed.
        """
        c = CArray.from_numpy(frame)
        ps, fs = pilot_sharding(self.mesh), frame_sharding(self.mesh)
        pilot = CArray(jax.device_put(c.re[0], ps), jax.device_put(c.im[0], ps))
        data = CArray(jax.device_put(c.re[1:], fs), jax.device_put(c.im[1:], fs))
        return pilot, data
