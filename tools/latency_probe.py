"""Per-symbol (ts=1) device-time probe: the low-latency streaming path.

The reference's main runtime loop demodulates ONE symbol at a time
(demodOneSymbol, gpuLS.cu:410-473).  This probe measures the per-symbol
step's sustained device time on a GPU with bench.py's R-loop differencing
(many symbols resident on the device, one program) for the streaming
bodies:

  composed          -- plain jitted ops (jnp.fft + MRC), models/streaming
  composed-sharded  -- the same through parallel/streaming on a 1x1 mesh
  fast-sharded      -- the DFT-as-GEMM body through parallel/streaming
  (any body)-sc16   -- the same symbols as planar int16, widened in-jit

Host dispatch latency is not in this number: it is the device time a
per-symbol program needs, the floor under a push-a-symbol round trip.

Usage:  python tools/latency_probe.py [--bodies composed,composed-sc16]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bodies", default="composed,composed-sc16")
    ap.add_argument("--batch", type=int, default=256,
                    help="device-resident symbols per measurement")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--r-hi", type=int, default=101)
    ap.add_argument("--antennas", type=int, default=16)
    ap.add_argument("--fft", type=int, default=1024)
    args = ap.parse_args()

    from ofdm_ls_mrc_tpu.utils import compile_cache
    from ofdm_ls_mrc_tpu.utils.device import card_info, require_gpu

    dev = require_gpu("latency_probe.py")
    compile_cache.enable()
    card = card_info()

    import jax
    import jax.numpy as jnp

    from ofdm_ls_mrc_tpu.config import FrameConfig
    from ofdm_ls_mrc_tpu.models.streaming import (
        _demod_symbol_fn,
        _estimate_symbol_fn,
    )
    from ofdm_ls_mrc_tpu.ops import ls as ls_ops
    from ofdm_ls_mrc_tpu.ops.cplx import CArray

    a, f, k = args.antennas, args.fft, args.batch
    cfg = FrameConfig(num_antennas=a, fft_size=f, cyclic_prefix=0,
                      frame_len=3)
    rng = np.random.default_rng(0)
    pilot_x = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    pilot_sym = (rng.standard_normal((a, f))
                 + 1j * rng.standard_normal((a, f))).astype(np.complex64)
    syms = (rng.standard_normal((k, a, f))
            + 1j * rng.standard_normal((k, a, f))).astype(np.complex64)
    csyms = CArray(jax.device_put(np.ascontiguousarray(syms.real)),
                   jax.device_put(np.ascontiguousarray(syms.imag)))
    # sc16 bodies: the SAME symbols quantized to the int16 wire format
    # (half the per-symbol input bytes; widened in-jit).
    scale = 0.25 / max(np.max(np.abs(syms.real)), np.max(np.abs(syms.imag)))
    i16 = np.round(syms * scale * 32767.0)
    csyms_i16 = CArray(
        jax.device_put(np.ascontiguousarray(i16.real).astype(np.int16)),
        jax.device_put(np.ascontiguousarray(i16.imag).astype(np.int16)))

    def measure(body):
        sc16 = body.endswith("-sc16")
        if sc16:
            body = body[:-len("-sc16")]
        data = csyms_i16 if sc16 else csyms
        if body in ("composed-sharded", "fast-sharded"):
            # The antenna-sharded per-symbol path (parallel/streaming.py) on
            # a 1x1 mesh: shard_map wrapper + the per-symbol numerator psum
            # (a 1-device no-op) ride inside the timed program.
            from ofdm_ls_mrc_tpu.parallel import (
                ShardedStreamingDemodulator, make_mesh)
            sd = ShardedStreamingDemodulator(
                cfg, pilot_x, make_mesh(1, 1, devices=jax.devices()[:1]),
                pipeline=body.split("-")[0])
            sd.push_pilot(pilot_sym)
            h, hnorm = sd._hconj, sd._hsqrd
            jax.block_until_ready(hnorm)
            demod = sd._demod  # jit-of-jit inlines inside the R-loop program
        elif body == "composed":
            x_full = ls_ops.pad_pilot(pilot_x)
            h, hnorm = jax.jit(functools.partial(
                _estimate_symbol_fn, cp=0, fft_impl="xla"))(
                    CArray.from_numpy(pilot_sym), x_full)
            demod = functools.partial(_demod_symbol_fn, cp=0,
                                      fft_impl="xla")
        else:
            raise SystemExit(f"unknown body {body!r}")
        jax.block_until_ready(hnorm)

        def prog_factory(r):
            def prog(syms, h, hnorm, c0):
                def rep(_, acc):
                    def step(cacc, sym):
                        # anti-elision: the normalizer varies per rep, so no
                        # per-symbol program is cacheable across reps.
                        out = demod(sym, h, hnorm + cacc)
                        return cacc + (jnp.sum(out.re)
                                       + jnp.sum(out.im)) * 1e-20, None
                    cacc, _ = jax.lax.scan(step, acc, syms)
                    return cacc
                return jax.lax.fori_loop(0, r, rep, c0)
            return jax.jit(prog)

        def timed(r):
            g = prog_factory(r)
            float(g(data, h, hnorm, 0.0))
            best = float("inf")
            for _ in range(args.reps):
                t0 = time.perf_counter()
                float(g(data, h, hnorm, 0.0))
                best = min(best, time.perf_counter() - t0)
            return best

        t1, thi = timed(1), timed(args.r_hi)
        return max(thi - t1, 1e-12) / ((args.r_hi - 1) * k)

    for body in args.bodies.split(","):
        t = measure(body)
        print(json.dumps({
            "metric": "device_us_per_symbol_ts1", "value": t * 1e6,
            "unit": "us", "body": body, "antennas": a, "fft": f,
            "samples_per_s": a * f / t, "symbols_resident": k,
            "r_hi": args.r_hi,
            "device": {key: dev[key] for key in ("platform", "kind", "count")},
            "xla_flags": dev["xla_flags"], "card": card}), flush=True)


if __name__ == "__main__":
    main()
