"""Downlink transmitter: multi-user zero-forcing precoding + OFDM modulation.

Covers the reference's CPU-only TX path (cpuLS.hpp:391-529): ZF precoder per
subcarrier, per-user modulation, cyclic-prefix insertion -- as batched jitted
planar ops instead of per-subcarrier cgemm/cgetri loops.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import jax
import numpy as np

from ..config import FrameConfig
from ..ops import fft as fft_ops
from ..ops import zf as zf_ops
from ..ops.cplx import CArray
from ..ops.modulate import modulate as modulate_op
from ..ops.modulate import modulate_frame_matched

ArrayLike = Union[np.ndarray, CArray]


def _as_carray(x: ArrayLike) -> CArray:
    return x if isinstance(x, CArray) else CArray.from_numpy(x)


def _precode_fn(h: CArray, x: CArray) -> CArray:
    """[S', U, A] channel + [U, S'] user symbols -> [A, S'] antenna streams."""
    w = zf_ops.zf_precoder(h)
    return zf_ops.apply_precoder(w, x)


class DownlinkTransmitter:
    """ZF-precoded multi-user OFDM transmitter.

    Usage:
      tx = DownlinkTransmitter(cfg)
      ant = tx.precode(h, user_syms)       # [A, S'] per-subcarrier ZF
      td = tx.modulate(ant_rows)           # [A, F+cp] time-domain symbols
    """

    def __init__(self, cfg: FrameConfig, fft_impl: Optional[str] = None):
        cfg.validate()
        self.cfg = cfg
        self.fft_impl = fft_impl or fft_ops.default_impl()
        self._precode = jax.jit(_precode_fn)
        self._modulate = jax.jit(functools.partial(
            modulate_op, cp=cfg.cyclic_prefix, impl=self.fft_impl))
        self._modulate_frame = jax.jit(functools.partial(
            modulate_frame_matched, cp=cfg.cyclic_prefix, impl=self.fft_impl))

    def precode(self, h: ArrayLike, user_syms: ArrayLike) -> CArray:
        """Per-subcarrier ZF: h [S', U, A], user_syms [U, S'] -> [A, S']."""
        return self._precode(_as_carray(h), _as_carray(user_syms))

    def modulate(self, data: ArrayLike) -> CArray:
        """[..., F-1] subcarrier rows -> [..., F+cp] time-domain symbols."""
        return self._modulate(_as_carray(data))

    def modulate_frame(self, data: ArrayLike, pilot_x: ArrayLike) -> CArray:
        """Receiver-matched frame: [S-1, F-1] + pilot -> [S, F+cp]."""
        return self._modulate_frame(_as_carray(data), _as_carray(pilot_x))
