"""ofdm_ls_mrc_tpu: a massive-MIMO OFDM LS+MRC uplink receiver in JAX.

A JAX/XLA re-design, run on NVIDIA GPUs, of the capabilities of
``bhargav0410/gpu-accel-ofdm-ls-mrc`` (CUDA/C++ reference): per-symbol FFT,
pilot-based Least-Squares channel estimation, Maximal Ratio Combining
demodulation, multi-user zero-forcing downlink, a producer/consumer shared
memory ring between the SDR ingest process and the compute process, and the
phase-timing benchmark harness.

Layers (bottom-up):
  golden/    pure-NumPy oracle, bit-faithful to the reference CPU chain
  ops/       JAX ops: FFT (jnp.fft / DFT-matmul / four-step), LS, MRC, ZF, mod
  models/    jitted pipelines: UplinkReceiver, DownlinkTransmitter, streaming;
             body.choose_body picks the device body for the platform
  parallel/  shard_map over an (ant, time) mesh; one MRC psum (NCCL)
  io/        C++ POSIX shm ring (ctypes), async double-buffered device feed
  sim/       synthetic channel, constellations, PN frame sync
  utils/     phase timers + avg/var report (reference printTimes analogue)
  apps/      CLI front-ends mirroring the reference SDR apps
"""

from .config import DEFAULT_FRAME, DEFAULT_RUNTIME, FrameConfig, MeshConfig, RuntimeConfig

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_FRAME",
    "DEFAULT_RUNTIME",
    "FrameConfig",
    "MeshConfig",
    "RuntimeConfig",
    "__version__",
]
