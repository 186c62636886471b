"""Typed runtime configuration for the OFDM LS+MRC receiver.

The reference scatters configuration across two tiers: compile-time ``#define``
macros for the DSP core (``numOfRows``/``dimension``/``prefix``/``lenOfBuffer``/
``numUsers``/``timerEnabled``/``testEnabled``, see reference
``ShMemSymBuff.hpp:41-75`` and ``ShMemSymBuff_cucomplex.hpp:49-83``) and runtime
boost::program_options flags for the SDR apps (``rx_and_corr.cpp:100-124``).
Here both tiers collapse into one frozen dataclass that every layer consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Geometry of one OFDM frame as it flows through the pipeline.

    Mirrors the reference defaults (``ShMemSymBuff.hpp:42-67``):
    ``numOfRows=16`` antennas x ``dimension=1024``-point FFT, cyclic prefix
    ``prefix=0`` (the live RX uses 72, ``rx_and_corr.cpp:120``), frame =
    ``lenOfBuffer`` symbols of which symbol 0 is the pilot.
    """

    num_antennas: int = 16          # numOfRows
    fft_size: int = 1024            # dimension
    cyclic_prefix: int = 0          # prefix
    frame_len: int = 101            # lenOfBuffer (ShMemSymBuff_gpu.hpp:73-75)
    num_users: int = 4              # numUsers (ShMemSymBuff_cucomplex.hpp:53-55)

    @property
    def num_subcarriers(self) -> int:
        """Data subcarriers: the DC bin is dropped (gpuLS.cuh:67-70)."""
        return self.fft_size - 1

    @property
    def num_data_symbols(self) -> int:
        """Symbols 1..frame_len-1 carry data; symbol 0 is the pilot."""
        return self.frame_len - 1

    @property
    def symbol_len(self) -> int:
        """Time-domain samples per OFDM symbol including cyclic prefix."""
        return self.fft_size + self.cyclic_prefix

    @property
    def samples_per_frame(self) -> int:
        """Complex samples per frame per antenna (incl. pilot and CP)."""
        return self.frame_len * self.symbol_len

    def validate(self) -> "FrameConfig":
        """Checks the constraints EVERY pipeline shares.  fft_size: the
        'fast' path factors it as (n1, n2) with n2 = 128 when divisible,
        else a near-square even split -- any even size >= 2 works."""
        if self.num_antennas < 1:
            raise ValueError("num_antennas must be >= 1")
        if self.fft_size < 2 or self.fft_size & 1:
            raise ValueError(
                f"fft_size must be an even size >= 2 (got {self.fft_size}); "
                "the 'fast' pipeline factors it into a near-square "
                "or (N/128, 128) split")
        if self.cyclic_prefix < 0:
            raise ValueError("cyclic_prefix must be >= 0")
        if self.frame_len < 2:
            raise ValueError("frame_len must hold a pilot plus >=1 data symbol")
        return self


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Runtime knobs: instrumentation, file paths, ring-buffer identity.

    Mirrors ``timerEnabled``/``testEnabled``/``shmemID`` (ShMemSymBuff.hpp:54-72)
    and the output-file conventions (``cpuLS.hpp:63``, ``gpuLS.cuh``).
    """

    timer_enabled: bool = True      # timerEnabled
    test_enabled: bool = True       # testEnabled
    shm_uid: str = "/ofdm_ring"     # shmemID "/blah"
    pilots_path: str = "Pilots.dat"             # fileNameForX (cpuLS.hpp:41)
    pn_path: str = "PNSeq_255_MaxLenSeq.dat"    # rx_and_corr.cpp:228
    output_path: str = "Output_gpu.dat"         # Output_gpu.dat (gpuLS.cuh)
    num_times: int = 1              # numTimes (ShMemSymBuff.hpp:75)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the sharded pipeline.

    The reference's concurrency axes (SURVEY.md section 2) map to a 2-D
    ``(ant, time)`` mesh: the antenna axis is reduced over by MRC (``psum``
    over ICI), the symbol/time axis is embarrassingly parallel.
    """

    ant_shards: int = 1
    time_shards: int = 1

    @property
    def num_devices(self) -> int:
        return self.ant_shards * self.time_shards


DEFAULT_FRAME = FrameConfig()
DEFAULT_RUNTIME = RuntimeConfig()
