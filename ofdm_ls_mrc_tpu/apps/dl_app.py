"""Downlink TX process: multi-user ZF precoding -> OFDM modulation -> capture.

The CLI entry for the reference's CPU-only multi-user downlink path
(createZeroForcingMatrix / multiplyWithChannelInv / modOneSymbol,
cpuLS.hpp:391-529, numUsers=4 per ShMemSymBuff_cucomplex.hpp:53-55), which
the reference exposes only as library functions.  Per data symbol: the
per-subcarrier ZF precoder maps U user streams onto A antennas (batched
solves, ops/zf.py), then each antenna row is OFDM-modulated with
max-abs normalization and cyclic prefix (ops/modulate.py).

Channel input: a complex64 file of shape [F-1, U, A] (downlink channel per
subcarrier, e.g. estimated uplink channels under reciprocity), or
``--simulate-channel`` to draw a random one.

Run:  python -m ofdm_ls_mrc_tpu.apps.dl_app --users 4 --antennas 16 \\
          --fft-size 1024 --cp-size 72 --frame-len 11 --out dl.dat --verify
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from ..sim.channel import CONSTELLATIONS
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--users", type=int, default=4,
                    help="spatially multiplexed user streams (numUsers)")
    ap.add_argument("--antennas", type=int, default=16)
    ap.add_argument("--fft-size", type=int, default=1024)
    ap.add_argument("--cp-size", type=int, default=72)
    ap.add_argument("--frame-len", type=int, default=11,
                    help="symbols per frame incl. the pilot slot")
    ap.add_argument("--num-frames", type=int, default=1)
    ap.add_argument("--out", required=True,
                    help="per-antenna IQ capture, complex64 [A, N] C-order")
    ap.add_argument("--out-format", default="cf32", choices=["cf32", "sc16"])
    ap.add_argument("--data-out", default=None,
                    help="write the per-user sent symbols ([U, S-1, F-1] "
                         "complex64) for EVM checks")
    ap.add_argument("--channel", default=None,
                    help="downlink channel file: complex64 [F-1, U, A]")
    ap.add_argument("--simulate-channel", action="store_true",
                    help="draw a random iid channel instead of --channel")
    ap.add_argument("--modulation", default="qpsk", choices=sorted(CONSTELLATIONS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="apply the channel to the precoded streams and "
                         "report per-user separation EVM (ZF removes "
                         "inter-user interference)")
    return ap


def load_channel(path: str, f: int, users: int, antennas: int) -> np.ndarray:
    h = np.fromfile(path, dtype=np.complex64)
    want = (f - 1) * users * antennas
    if h.size != want:
        raise SystemExit(f"{path}: {h.size} samples != (F-1)*U*A = {want}")
    return h.reshape(f - 1, users, antennas)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..utils import compile_cache
    compile_cache.enable()

    from ..config import FrameConfig
    from ..models.downlink import DownlinkTransmitter
    from ..sim.channel import random_symbols
    from .tx_app import _write_capture

    if args.users > args.antennas:
        raise SystemExit(f"ZF needs U <= A ({args.users} > {args.antennas})")
    cfg = FrameConfig(num_antennas=args.antennas, fft_size=args.fft_size,
                      cyclic_prefix=args.cp_size, frame_len=args.frame_len)
    rng = np.random.default_rng(args.seed)
    f, u, a = args.fft_size, args.users, args.antennas

    if args.channel:
        h = load_channel(args.channel, f, u, a)
    elif args.simulate_channel:
        h = ((rng.standard_normal((f - 1, u, a))
              + 1j * rng.standard_normal((f - 1, u, a))) / np.sqrt(2)
             ).astype(np.complex64)
    else:
        raise SystemExit("need --channel FILE or --simulate-channel")

    tx = DownlinkTransmitter(cfg)
    s_data = cfg.num_data_symbols
    streams = []
    sent = []
    last_precoded = []     # last frame's [A, F-1] streams, reused by --verify
    for _ in range(args.num_frames):
        data, _ = random_symbols(rng, (u, s_data, f - 1), args.modulation)
        sent.append(data)
        last_precoded = []
        for s in range(s_data):
            ant = tx.precode(h, data[:, s, :])          # [A, F-1]
            last_precoded.append(ant.to_numpy())
            td = tx.modulate(ant)                       # [A, F+cp]
            streams.append(td.to_numpy())
    out = np.concatenate(streams, axis=1)               # [A, N]
    _write_capture(out, args.out, args.out_format)
    if args.data_out:
        np.concatenate(sent, axis=1).astype(np.complex64).tofile(args.data_out)

    print(f"DL: wrote {args.out} ({args.num_frames} frame(s), {u} users x "
          f"{a} antennas, {s_data} data symbols/frame)")

    if args.verify:
        # Per-subcarrier channel application BEFORE modulation order:
        # y_u[k] = sum_a h[k, u, a] * ant[a, k] must recover x_u[k].
        data = sent[-1]
        worst = -np.inf
        for s in range(s_data):
            ant = last_precoded[s]                           # [A, F-1] cached
            y = np.einsum("kua,ak->uk", h, ant)              # [U, F-1]
            x = data[:, s, :]
            evm = 10 * np.log10(np.mean(np.abs(y - x) ** 2)
                                / np.mean(np.abs(x) ** 2))
            worst = max(worst, evm)
        print(f"ZF separation EVM (worst symbol): {worst:.1f} dB")
        if worst > -40.0:
            print("FAIL: inter-user interference not removed", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
