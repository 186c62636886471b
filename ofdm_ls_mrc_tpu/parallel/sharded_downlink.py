"""Sharded downlink: subcarrier-parallel ZF precoding, row-parallel modulation.

The reference's downlink (cpuLS.hpp:391-529) is a CPU-only serial loop: one
``cgemm`` + ``cgetrf_/cgetri_`` per subcarrier to build the zero-forcing
precoder (createZeroForcingMatrix, cpuLS.hpp:415-447) and one ``cgemv`` per
subcarrier to apply it (multiplyWithChannelInv, cpuLS.hpp:449-463).  Both are
embarrassingly parallel over the subcarrier axis, so the layout here
shards that axis over EVERY device of the (ant, time) mesh -- there is no
cross-subcarrier coupling, hence zero collectives; XLA only gathers at the
jit boundary if the caller fetches the result to host.

The 1023-subcarrier axis is not divisible by typical mesh sizes, so inputs
are padded up to the device count before placement (the channel pad
replicates the last subcarrier's H to keep every padded Gram system
invertible) and the pad is sliced off at the edge -- the same
"full-width compute, trim at the boundary" stance as the uplink's masked DC
bin (SURVEY.md section 7 hard parts).
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import FrameConfig
from ..ops import fft as fft_ops
from ..ops import zf as zf_ops
from ..ops.cplx import CArray
from ..ops.modulate import modulate as modulate_op
from .mesh import ANT_AXIS, TIME_AXIS

ArrayLike = Union[np.ndarray, CArray]
_ALL = (ANT_AXIS, TIME_AXIS)  # both mesh axes flattened into one data axis


def _to_numpy(x: ArrayLike) -> np.ndarray:
    return x.to_numpy() if isinstance(x, CArray) else np.asarray(x, np.complex64)


def _pad_rows(x: np.ndarray, mult: int, edge: bool) -> np.ndarray:
    """Pad axis 0 of ``x`` up to a multiple of ``mult`` (edge-replicate or zero)."""
    n = x.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return x
    tail = (np.repeat(x[-1:], pad, axis=0) if edge
            else np.zeros((pad,) + x.shape[1:], x.dtype))
    return np.concatenate([x, tail], axis=0)


def _precode_fn(h: CArray, x: CArray) -> CArray:
    w = zf_ops.zf_precoder(h)
    return zf_ops.apply_precoder(w, x)


class ShardedDownlinkTransmitter:
    """Multi-user ZF downlink over a device mesh.

    Subcarriers shard over all mesh devices for the precoder build/apply
    (batched 2Ux2U real block solves per shard, no collectives); the per-row
    OFDM modulator shards its leading (antenna/user) axis the same way.

    Usage:
      tx = ShardedDownlinkTransmitter(cfg, make_mesh(4, 2))
      ant = tx.precode(h, user_syms)    # h [S', U, A], user_syms [U, S'] -> [A, S']
      td  = tx.modulate(ant.to_numpy())                  # [A, F+cp] time rows
    """

    def __init__(self, cfg: FrameConfig, mesh: Mesh,
                 fft_impl: Optional[str] = None):
        cfg.validate()
        self.cfg = cfg
        self.mesh = mesh
        self.n_dev = int(np.prod(list(mesh.shape.values())))
        self.fft_impl = fft_impl or fft_ops.default_impl()

        self._h_sharding = NamedSharding(mesh, P(_ALL))        # [S', U, A] on S'
        self._x_sharding = NamedSharding(mesh, P(None, _ALL))  # [U, S'] on S'
        self._row_sharding = NamedSharding(mesh, P(_ALL))      # [R, ...] on R
        # Antenna streams come back subcarrier-sharded ([A, S'] on S'): the
        # natural producer layout; jit gathers only if the host fetches.
        self._precode = jax.jit(
            _precode_fn, out_shardings=NamedSharding(mesh, P(None, _ALL)))
        self._modulate = jax.jit(
            functools.partial(modulate_op, cp=cfg.cyclic_prefix,
                              impl=self.fft_impl),
            out_shardings=self._row_sharding)

    def precode(self, h: ArrayLike, user_syms: ArrayLike) -> CArray:
        """Per-subcarrier ZF: h [S', U, A], user_syms [U, S'] -> [A, S']."""
        hn, xn = _to_numpy(h), _to_numpy(user_syms)
        subs = hn.shape[0]
        # Edge-replicated channel pad keeps every padded Gram invertible;
        # the padded user symbols are zero so the pad carries no energy.
        hp = CArray.from_numpy(_pad_rows(hn, self.n_dev, edge=True))
        xp = CArray.from_numpy(_pad_rows(xn.T, self.n_dev, edge=False).T)
        hp = CArray(jax.device_put(hp.re, self._h_sharding),
                    jax.device_put(hp.im, self._h_sharding))
        xp = CArray(jax.device_put(xp.re, self._x_sharding),
                    jax.device_put(xp.im, self._x_sharding))
        out = self._precode(hp, xp)
        return CArray(out.re[:, :subs], out.im[:, :subs])

    def modulate(self, data: ArrayLike) -> CArray:
        """[R, F-1] subcarrier rows -> [R, F+cp], rows sharded over the mesh."""
        dn = _to_numpy(data)
        rows = dn.shape[0]
        dp = CArray.from_numpy(_pad_rows(dn, self.n_dev, edge=False))
        dp = CArray(jax.device_put(dp.re, self._row_sharding),
                    jax.device_put(dp.im, self._row_sharding))
        out = self._modulate(dp)
        return CArray(out.re[:rows], out.im[:rows])
