"""Minimal end-to-end demod: synthetic channel -> LS + MRC receiver -> EVM.

The 60-second tour of the framework, equivalent to the reference's
cpuLS_main.cpp run (firstVector + doOneSymbol over one frame) but with the
synthetic channel the reference lacks.  Runs on the CPU or a GPU with the
same body: jnp.fft (cuFFT on the GPU) plus the XLA-fused LS/MRC.

  python examples/01_loopback_demod.py [--platform cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None,
                    help="pin jax_platforms (e.g. cpu); default: best backend")
    ap.add_argument("--snr", type=float, default=25.0)
    args = ap.parse_args(argv)
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    from ofdm_ls_mrc_tpu import FrameConfig
    from ofdm_ls_mrc_tpu.models import UplinkReceiver
    from ofdm_ls_mrc_tpu.sim import (ChannelModel, evm_db, make_tx_frame,
                                     random_symbols)

    # Reference geometry: 16 antennas x 1024-point FFT x 101 symbols
    # (1 pilot + 100 data), 72-sample cyclic prefix (rx_and_corr.cpp:120).
    cfg = FrameConfig(num_antennas=16, fft_size=1024, cyclic_prefix=72,
                      frame_len=101)
    rng = np.random.default_rng(7)

    # TX side: random 16-QAM grid + constant-modulus pilot.
    data, _ = random_symbols(rng, (cfg.num_data_symbols, cfg.num_subcarriers),
                             "16qam")
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)
                   ).astype(np.complex64)
    tx = make_tx_frame(data, pilot, cfg.cyclic_prefix)

    # 16-antenna frequency-selective Rayleigh channel + AWGN.
    chan = ChannelModel(cfg.num_antennas, cfg.fft_size, num_taps=16,
                        snr_db=args.snr, seed=9)
    rx_frame = chan.apply(tx, cfg.cyclic_prefix)   # [S, A, F+cp] complex64

    # RX side: one object, one call.
    rx = UplinkReceiver(cfg, pilot)
    out = rx.demod_frame(rx_frame).to_numpy()      # [S-1, F-1] complex64

    # The output is in the reference's layout (final fftshift applied,
    # cpuLS.hpp:368); undo it to compare against the sent grid.
    evm = evm_db(np.fft.fftshift(out, axes=-1), data)
    print(f"pipeline={rx.pipeline}  EVM={evm:.1f} dB "
          f"(channel SNR {args.snr:.0f} dB + MRC array gain)")
    ok = evm < -(args.snr)  # array gain must at least beat the channel SNR
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
