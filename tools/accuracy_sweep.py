"""Accuracy sweep: EVERY shipped demod body vs the NumPy golden oracle.

The single-body accuracy gate (tools/gate.py) historically covered one
receiver at one geometry; this sweep drives each body the CLIs can select
-- {fast, composed} x FFT implementations x {whole-frame, streaming}
unsharded, and {fast, composed} x {whole-frame 2x2, per-symbol-streaming
2x1} sharded -- against dsp.demod_frame at a -70 dB EVM bound.  Matches the
reference's golden-file contract (cpuLS.hpp:374-380) for every pipeline,
not just the flagship.

Run directly or via ``gate.py`` (which invokes this once on the ambient
backend for the unsharded legs and once on a forced 8-device CPU mesh for
the sharded legs):

  python tools/accuracy_sweep.py                 # unsharded bodies
  python tools/accuracy_sweep.py --mesh-legs     # sharded bodies (CPU mesh)
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))

EVM_DB = -70.0


def _evm_db(got, want):
    import numpy as np

    err = float(np.mean(np.abs(got - want) ** 2))
    ref = float(np.mean(np.abs(want) ** 2))
    import math
    return 10.0 * math.log10(err / max(ref, 1e-30) + 1e-30)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh-legs", action="store_true",
                    help="run the SHARDED bodies on a forced 8-device CPU "
                         "mesh (single-chip hardware cannot host a 2x2 "
                         "mesh; the shard bodies are backend-agnostic)")
    args = ap.parse_args()

    if args.mesh_legs:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()

    import numpy as np
    import jax

    from ofdm_ls_mrc_tpu import FrameConfig
    from ofdm_ls_mrc_tpu.golden import dsp

    # Small geometry: compiles fast on every backend, data symbols
    # divisible by 2 time shards.
    a, f, cp, s = 4, 256, 16, 7
    cfg = FrameConfig(num_antennas=a, fft_size=f, cyclic_prefix=cp,
                      frame_len=s)
    rng = np.random.default_rng(11)
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    frame = (0.1 * (rng.standard_normal((s, a, f + cp))
                    + 1j * rng.standard_normal((s, a, f + cp)))
             ).astype(np.complex64)
    gold = dsp.demod_frame(frame, pilot, cp)

    failures = []

    def check(name, got, bound=EVM_DB):
        evm = _evm_db(np.asarray(got), gold)
        ok = evm <= bound
        print(f"[sweep] {name:42s} {evm:8.1f} dB vs bound {bound:.0f}: "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(name)

    if not args.mesh_legs:
        from ofdm_ls_mrc_tpu.models import StreamingDemodulator, UplinkReceiver

        backend = jax.default_backend()
        for pipe, impl in (("fast", None), ("composed", "xla"),
                           ("composed", "four_step"),
                           ("composed", "matmul")):
            rx = UplinkReceiver(cfg, pilot, pipeline=pipe, fft_impl=impl)
            check(f"whole/{pipe}/{impl or 'gemm'} ({backend})",
                  rx.demod_frame(frame).to_numpy())
        for impl in ("xla", "four_step"):
            sd = StreamingDemodulator(cfg, pilot, fft_impl=impl)
            sd.push_pilot(frame[0])
            rows = np.stack([sd.push_symbol(frame[i]).to_numpy()
                             for i in range(1, s)])
            check(f"streaming/composed/{impl} ({backend})", rows)
    else:
        from ofdm_ls_mrc_tpu.parallel import (
            ShardedStreamingDemodulator,
            ShardedUplinkReceiver,
            make_mesh,
        )

        assert len(jax.devices()) >= 8, "conftest-style 8-device CPU mesh"
        mesh22 = make_mesh(2, 2)
        for pipe in ("fast", "composed"):
            rx = ShardedUplinkReceiver(cfg, pilot, mesh22, pipeline=pipe)
            check(f"sharded-whole/{pipe} (2x2 cpu)",
                  rx.demod_frame(frame).to_numpy())
        mesh21 = make_mesh(2, 1)
        for pipe in ("fast", "composed"):
            sd = ShardedStreamingDemodulator(cfg, pilot, mesh21,
                                             pipeline=pipe)
            sd.push_pilot(frame[0])
            rows = np.stack([sd.push_symbol(frame[i]).to_numpy()
                             for i in range(1, s)])
            check(f"sharded-streaming/{pipe} (2x1 cpu)", rows)

    if failures:
        print(f"[sweep] FAILED: {', '.join(failures)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
