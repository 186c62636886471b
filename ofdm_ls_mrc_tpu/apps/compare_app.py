"""Output-file comparison: the reference's golden verification workflow.

The reference verifies its GPU chain by dumping demodulated symbols from
both implementations (Output_cpu.dat / Output_gpu.dat, cpuLS.hpp:374-380,
gpuLS_main.cu:114-126) and comparing offline (out-of-repo).  This app IS
that offline comparison: EVM between two raw-complex64 output files, with a
pass/fail threshold for CI gating.

Run:  python -m ofdm_ls_mrc_tpu.apps.compare_app a.dat b.dat \\
          --subcarriers 1023 --threshold-db -40
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("file_a", help="reference output (e.g. Output_cpu.dat)")
    ap.add_argument("file_b", help="candidate output (e.g. Output_gpu.dat)")
    ap.add_argument("--subcarriers", type=int, default=1023,
                    help="row width (dimension-1)")
    ap.add_argument("--threshold-db", type=float, default=-40.0,
                    help="fail if EVM exceeds this (dB)")
    ap.add_argument("--max-symbols", type=int, default=None,
                    help="compare only the first N symbol rows")
    from ..sim.channel import CONSTELLATIONS
    ap.add_argument("--modulation", choices=sorted(CONSTELLATIONS),
                    default=None,
                    help="hard-decision demap both files against this "
                         "constellation and report the symbol error rate "
                         "(file_a is the truth, e.g. the sent grid)")
    ap.add_argument("--ser-threshold", type=float, default=None,
                    help="with --modulation: fail if SER exceeds this "
                         "(e.g. 0 for a zero-error gate)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..golden.io import read_output
    from ..sim.channel import evm_db

    a = read_output(args.file_a, args.subcarriers)
    b = read_output(args.file_b, args.subcarriers)
    n = min(len(a), len(b),
            len(a) if args.max_symbols is None else args.max_symbols)
    if n == 0:
        print("no symbols to compare", file=sys.stderr)
        return 2
    if len(a) != len(b):
        print(f"note: lengths differ ({len(a)} vs {len(b)}); comparing first {n}")
    a, b = a[:n], b[:n]

    evm = evm_db(b, a)
    max_err = float(np.max(np.abs(a - b)))
    rms_ref = float(np.sqrt(np.mean(np.abs(a) ** 2)))
    print(f"symbols: {n} x {args.subcarriers}")
    print(f"EVM:     {evm:.2f} dB (threshold {args.threshold_db:.2f})")
    print(f"max |err|: {max_err:.3e} (ref RMS {rms_ref:.3e})")
    failed = evm > args.threshold_db
    if args.modulation is not None:
        from ..sim.channel import demap_symbols
        errors = int(np.sum(demap_symbols(a, args.modulation)
                            != demap_symbols(b, args.modulation)))
        ser = errors / a.size
        gate = ("" if args.ser_threshold is None
                else f" (threshold {args.ser_threshold:g})")
        print(f"SER:     {ser:.3e} ({errors}/{a.size} {args.modulation}"
              f" decisions differ){gate}")
        if args.ser_threshold is not None and ser > args.ser_threshold:
            failed = True
    if failed:
        print("FAIL", file=sys.stderr)
        return 1
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
