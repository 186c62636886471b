"""Antenna-sharded MRC over a device mesh: the multi-chip path on 8 virtual
CPU devices.

The MRC reduction is the framework's cross-chip collective: each antenna
shard computes its local FFT + LS + MRC numerator, then ONE fused psum
carries (num_re, num_im, sum|H|^2) over the `ant` mesh axis (the
collective form of the reference's antenna tree-reduction,
gpuLS.cu:247-259).  Run this anywhere -- it forces an 8-device virtual CPU
mesh; on a host of GPUs the same code spans the cards (NCCL over NVLink).

  python examples/03_sharded_mesh.py
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main() -> int:
    from ofdm_ls_mrc_tpu import FrameConfig
    from ofdm_ls_mrc_tpu.parallel import ShardedUplinkReceiver, make_mesh
    from ofdm_ls_mrc_tpu.sim import (ChannelModel, evm_db, make_tx_frame,
                                     random_symbols)

    # 4 antenna shards x 2 time shards; 16 antennas -> 4 per shard.
    mesh = make_mesh(ant_shards=4, time_shards=2)
    cfg = FrameConfig(num_antennas=16, fft_size=256, cyclic_prefix=32,
                      frame_len=9)
    rng = np.random.default_rng(3)
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)
                   ).astype(np.complex64)
    data, _ = random_symbols(rng, (cfg.num_data_symbols, cfg.num_subcarriers))
    rx_frame = ChannelModel(cfg.num_antennas, cfg.fft_size, num_taps=8,
                            snr_db=30.0, seed=5).apply(
        make_tx_frame(data, pilot, cfg.cyclic_prefix), cfg.cyclic_prefix)

    rx = ShardedUplinkReceiver(cfg, pilot, mesh)
    out = rx.demod_frame(rx_frame).to_numpy()
    evm = evm_db(np.fft.fftshift(out, axes=-1), data)
    print(f"mesh={dict(zip(mesh.axis_names, mesh.devices.shape))} "
          f"pipeline={rx.pipeline}  EVM={evm:.1f} dB")

    # Low-latency variant: the antenna-sharded per-symbol streaming path --
    # estimate device-resident per shard, ONE 2*F-word psum per symbol.
    from ofdm_ls_mrc_tpu.parallel import ShardedStreamingDemodulator

    sd = ShardedStreamingDemodulator(cfg, pilot, make_mesh(8, 1),
                                     pipeline="fast")
    sd.push_pilot(rx_frame[0])
    rows = [sd.push_symbol(s).to_numpy() for s in rx_frame[1:]]
    evm_s = evm_db(np.fft.fftshift(np.stack(rows), axes=-1), data)
    print(f"per-symbol streaming over 8 ant shards: EVM={evm_s:.1f} dB")

    ok = evm < -25.0 and evm_s < -25.0
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
