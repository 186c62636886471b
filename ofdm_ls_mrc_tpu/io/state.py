"""Receiver state persistence (checkpoint/resume).

The reference has no checkpointing; its nearest analogue is its set of
persisted .dat files (SURVEY.md section 5).  Streaming deployments of this
framework want more: a receiver restarted mid-capture should resume with the
last good channel estimate instead of waiting for the next pilot.  State is
a single .npz with a version tag and the frame geometry, so a mismatched
restore fails loudly instead of demodulating garbage.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Tuple

import numpy as np

from ..config import FrameConfig

if TYPE_CHECKING:  # JAX is imported only where an estimate is loaded
    from ..ops.cplx import CArray

_VERSION = 1


def save_estimate(path: str, cfg: FrameConfig, hconj: CArray,
                  hsqrd, frame_index: int = 0) -> None:
    """Persist a channel estimate (full-grid, true frequency order).

    Written to the EXACT path given (np.savez would otherwise append .npz,
    breaking save/resume roundtrips on extensionless paths)."""
    with open(path, "wb") as fh:
        np.savez(
            fh,
            version=_VERSION,
            num_antennas=cfg.num_antennas,
            fft_size=cfg.fft_size,
            cyclic_prefix=cfg.cyclic_prefix,
            frame_len=cfg.frame_len,
            frame_index=frame_index,
            hconj_re=np.asarray(hconj.re),
            hconj_im=np.asarray(hconj.im),
            hsqrd=np.asarray(hsqrd),
        )


def load_estimate(path: str,
                  cfg: FrameConfig) -> Tuple["CArray", np.ndarray, int]:
    """Restore (hconj, hsqrd, frame_index), validating geometry."""
    import jax.numpy as jnp

    from ..ops.cplx import CArray

    with np.load(path) as z:
        if int(z["version"]) != _VERSION:
            raise ValueError(f"state version {int(z['version'])} != {_VERSION}")
        for field in ("num_antennas", "fft_size", "cyclic_prefix", "frame_len"):
            want = getattr(cfg, field)
            got = int(z[field])
            if got != want:
                raise ValueError(f"state {field}={got} != config {want}")
        want = (cfg.num_antennas, cfg.fft_size)
        for key in ("hconj_re", "hconj_im"):
            if z[key].shape != want:
                raise ValueError(f"{path}: {key} shape {z[key].shape} != {want}")
        if z["hsqrd"].shape != (cfg.fft_size,):
            raise ValueError(f"{path}: hsqrd shape {z['hsqrd'].shape} != "
                             f"({cfg.fft_size},)")
        hconj = CArray(jnp.asarray(z["hconj_re"]), jnp.asarray(z["hconj_im"]))
        return hconj, jnp.asarray(z["hsqrd"]), int(z["frame_index"])
