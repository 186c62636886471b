"""CI regression gate (SURVEY.md section 7 step 8): one command, nonzero
exit on an accuracy regression.

Demodulate a synthetic 25 dB-SNR frame with the shipped pipeline and with
the NumPy golden (the cpuLS stand-in), dump both in the reference's
Output_*.dat layout, and compare through compare_app (the reference's own
golden-file verification workflow, cpuLS.hpp:374-380) at a -70 dB EVM
threshold -- far tighter than the -40 dB BASELINE contract, loose enough
for fp32-grade noise; then run tools/accuracy_sweep.py over the other
bodies.  Speed is judged per cell by the benchmark's ledger, not here.

Usage:
  python tools/gate.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

EVM_THRESHOLD_DB = -70.0


def gate_accuracy() -> int:
    import numpy as np

    from ofdm_ls_mrc_tpu import FrameConfig
    from ofdm_ls_mrc_tpu.golden import dsp
    from ofdm_ls_mrc_tpu.golden.io import append_output
    from ofdm_ls_mrc_tpu.models import UplinkReceiver
    from ofdm_ls_mrc_tpu.sim import ChannelModel, make_tx_frame, random_symbols

    rng = np.random.default_rng(7)
    cfg = FrameConfig(num_antennas=16, fft_size=1024, cyclic_prefix=72,
                      frame_len=101)
    data, _ = random_symbols(rng, (cfg.num_data_symbols, cfg.num_subcarriers),
                             "16qam")
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)
                   ).astype(np.complex64)
    frame = ChannelModel(16, 1024, num_taps=16, snr_db=25.0, seed=9).apply(
        make_tx_frame(data, pilot, 72), 72)

    rx = UplinkReceiver(cfg, pilot)
    got = rx.demod_frame(frame).to_numpy()
    gold = dsp.demod_frame(frame, pilot, 72)

    with tempfile.TemporaryDirectory() as td:
        a, b = os.path.join(td, "gold.dat"), os.path.join(td, "gpu.dat")
        append_output(a, gold, truncate=True)
        append_output(b, got, truncate=True)
        r = subprocess.run(
            [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.compare_app", a, b,
             "--subcarriers", str(cfg.num_subcarriers),
             "--threshold-db", str(EVM_THRESHOLD_DB)],
            cwd=REPO, env={**os.environ})
    print(f"[gate] accuracy ({rx.pipeline} pipeline vs golden, "
          f"{EVM_THRESHOLD_DB:.0f} dB): "
          f"{'PASS' if r.returncode == 0 else 'FAIL'}")
    rc = r.returncode

    # Every OTHER shipped body: the sweep covers {fast, composed} x
    # {whole, streaming} unsharded on the ambient backend, and the sharded
    # bodies (whole 2x2, per-symbol 2x1) on a forced 8-device CPU mesh.
    for legs in ([], ["--mesh-legs"]):
        sw = subprocess.run(
            [sys.executable, os.path.join("tools", "accuracy_sweep.py")]
            + legs, cwd=REPO, env={**os.environ})
        name = "sharded bodies (cpu mesh)" if legs else "unsharded bodies"
        print(f"[gate] accuracy sweep, {name}: "
              f"{'PASS' if sw.returncode == 0 else 'FAIL'}")
        rc |= sw.returncode
    return rc


def main() -> int:
    rc = gate_accuracy()
    print(f"[gate] {'ALL PASS' if rc == 0 else 'REGRESSION DETECTED'}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
