"""Benchmark: device time per frame of the receiver's jitted demod body.

The kernel layer of a cell: K frames resident on the device, the reference's
16-antenna x 1024-subcarrier x 101-symbol frame (gpuLS_main.cu) by default,
with the cyclic prefix stripped on the host the way the ring's copy-out
strips it (ShMemSymBuff.hpp:281-294).  Served-path costs (ring read, the
host-to-device copy, the output write) are not in this number.

Method: the whole measurement runs INSIDE one jitted program -- a scan over
the K resident frames repeated R times, with a scalar data dependency
chaining repetitions (preventing elision), synchronized by fetching one
scalar.  Per-frame time is the R=r_hi vs R=1 difference divided by the extra
frames, so the fixed dispatch and sync cost cancels exactly.

Each cell is one body x input format: ``composed`` (jnp.fft = cuFFT + the
XLA-fused LS/MRC; the default) or ``fast`` (DFT-as-GEMM at HIGHEST
precision), fed ``sc16`` (planar int16, widened in the jitted body; the
default) or ``f32`` planes.  Every line names the device as JAX reports it,
XLA_FLAGS, and the card's name and power limit; beside the time it prints
the bytes a frame must move and the HBM floor those bytes set.  With no GPU
it exits non-zero instead of measuring the CPU.

Run:  python bench.py                       # default cell: composed/sc16
      python bench.py --cells composed/sc16,composed/f32,fast/sc16,fast/f32
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np

# Published peaks, keyed by jax's device_kind (NVIDIA data sheets; dense
# rates, full power limit).  A device missing here is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12,
                              "source": "NVIDIA H100 SXM5 data sheet"},
}

PIPELINES = ("composed", "fast")
INPUTS = ("sc16", "f32")


def parse_cells(spec: str):
    """'composed/sc16,fast/f32' -> [('composed', 'sc16'), ('fast', 'f32')]."""
    cells = []
    for item in spec.split(","):
        pipeline, _, inp = item.strip().partition("/")
        if pipeline not in PIPELINES or inp not in INPUTS:
            raise SystemExit(f"--cells {item!r}: expected PIPELINE/INPUT with "
                             f"PIPELINE in {PIPELINES} and INPUT in {INPUTS}")
        cells.append((pipeline, inp))
    return cells


def bytes_per_frame(cfg, input_dtype: str) -> int:
    """The least bytes one frame's device pass moves: the CP-free input
    planes read once and the [S-1, F-1] complex64 output written once."""
    itemsize = 2 if input_dtype == "sc16" else 4
    inp = cfg.frame_len * cfg.num_antennas * cfg.fft_size * 2 * itemsize
    out = cfg.num_data_symbols * cfg.num_subcarriers * 8
    return inp + out


def make_frames(cfg, batch: int, rng) -> np.ndarray:
    """[K, S, A, F] complex64 frames scaled to stay inside sc16 full scale."""
    shape = (batch, cfg.frame_len, cfg.num_antennas, cfg.symbol_len)
    return (0.25 * (rng.standard_normal(shape)
                    + 1j * rng.standard_normal(shape))).astype(np.complex64)


def to_planes(frames: np.ndarray, input_dtype: str):
    """Host complex64 frames -> planar (re, im) in the cell's wire format."""
    re = np.ascontiguousarray(frames.real, dtype=np.float32)
    im = np.ascontiguousarray(frames.imag, dtype=np.float32)
    if input_dtype == "sc16":
        from ofdm_ls_mrc_tpu.golden.io import plane_to_sc16
        return plane_to_sc16(re), plane_to_sc16(im)
    return re, im


def demod_body(cfg, pilot, pipeline: str):
    """(fn(frame, xref) -> CArray, xref) for the body ``pipeline``: the same
    traced function the receiver jits (models/uplink.py)."""
    if pipeline == "fast":
        from ofdm_ls_mrc_tpu.ops.fastpath import (
            demod_frame_fast,
            prepare_pilot_fast,
        )
        fn = functools.partial(demod_frame_fast, cp=cfg.cyclic_prefix)
        return (lambda x, xp: fn(x, x_full_perm=xp),
                prepare_pilot_fast(pilot, cfg.fft_size))
    from ofdm_ls_mrc_tpu.models.uplink import demod_frame_fn
    from ofdm_ls_mrc_tpu.ops import fft as fft_ops
    from ofdm_ls_mrc_tpu.ops.ls import pad_pilot
    fn = functools.partial(demod_frame_fn, cp=cfg.cyclic_prefix,
                           fft_impl=fft_ops.default_impl())
    return (lambda x, xp: fn(x, x_full=xp)), pad_pilot(pilot)


def _repeated(call, reps: int):
    """Repeat-R program with the anti-elision data dependency threaded through
    the [F] pilot reference (a trivial add) rather than the frame tensor:
    every repetition computes a different channel estimate (so nothing is
    cached across reps) while the frames stay resident and untouched."""
    import jax
    import jax.numpy as jnp

    from ofdm_ls_mrc_tpu.ops.cplx import CArray

    def prog(xs, xp):
        def rep(_, acc):
            def body(c, x):
                out = call(x, CArray(xp.re + c, xp.im))
                return c + (jnp.sum(out.re) + jnp.sum(out.im)) * 1e-20, None
            c, _ = jax.lax.scan(body, acc, xs)
            return c
        return jax.lax.fori_loop(0, reps, rep, 0.0)

    return jax.jit(prog)


def time_r_loop(call, xs, xp, k: int, reps: int, r_hi: int):
    """(seconds per frame, compile seconds) by R-loop differencing."""
    compile_s = 0.0

    def timed(r):
        nonlocal compile_s
        f = _repeated(call, r)
        t0 = time.perf_counter()
        float(f(xs, xp))          # compile + warm
        first = time.perf_counter() - t0
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            float(f(xs, xp))
            best = min(best, time.perf_counter() - t0)
        compile_s += max(first - best, 0.0)
        return best

    t1, thi = timed(1), timed(r_hi)
    return max(thi - t1, 1e-12) / ((r_hi - 1) * k), compile_s


def bench_frames(cfg, pilot, frames: np.ndarray, reps: int,
                 pipeline: str = "composed", input_dtype: str = "sc16",
                 r_hi: int = 101):
    """(seconds per frame, compile seconds) for one unsharded cell."""
    import jax

    from ofdm_ls_mrc_tpu.ops.cplx import CArray

    call, xp = demod_body(cfg, pilot, pipeline)
    re, im = to_planes(frames, input_dtype)
    xs = CArray(jax.device_put(re), jax.device_put(im))
    return time_r_loop(call, xs, xp, frames.shape[0], reps, r_hi)


def psum_payload_bytes(cfg, n_time: int) -> int:
    """Logical bytes each device contributes to the fused MRC psum per frame:
    the (num_re, num_im, |H|^2) payload -- (2*S_local + 1) * F fp32 words,
    S_local = data symbols per time shard.  The collective form of the
    reference's antenna tree-reduction (gpuLS.cu:198-203,247-252)."""
    s_local = cfg.num_data_symbols // n_time
    return (2 * s_local + 1) * cfg.fft_size * 4


def bench_sharded(cfg, pilot, frames: np.ndarray, reps: int,
                  mesh_shape, pipeline: str = "composed", r_hi: int = 101,
                  input_dtype: str = "f32") -> float:
    """Seconds per frame for the SHARDED receiver over an (ant, time) mesh:
    the same R-loop as ``bench_frames`` with (pilot, data) placed with the
    mesh shardings, so the timed program holds only the shard body and its
    one fused psum over the ``ant`` axis."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ofdm_ls_mrc_tpu.ops.cplx import CArray
    from ofdm_ls_mrc_tpu.parallel import ShardedUplinkReceiver, make_mesh
    from ofdm_ls_mrc_tpu.parallel.mesh import ANT_AXIS, TIME_AXIS

    n_ant, n_time = mesh_shape
    ndev = n_ant * n_time
    devs = jax.devices()
    if len(devs) < ndev:
        raise SystemExit(f"--mesh {n_ant}x{n_time} needs {ndev} devices, "
                         f"have {len(devs)}")
    mesh = make_mesh(n_ant, n_time, devices=devs[:ndev])
    rx = ShardedUplinkReceiver(cfg, pilot, mesh, pipeline=pipeline)
    re, im = to_planes(frames, input_dtype)             # [K, S, A, N]
    ps = NamedSharding(mesh, P(None, ANT_AXIS, None))
    ds = NamedSharding(mesh, P(None, TIME_AXIS, ANT_AXIS, None))
    pilots = CArray(jax.device_put(np.ascontiguousarray(re[:, 0]), ps),
                    jax.device_put(np.ascontiguousarray(im[:, 0]), ps))
    datas = CArray(jax.device_put(np.ascontiguousarray(re[:, 1:]), ds),
                   jax.device_put(np.ascontiguousarray(im[:, 1:]), ds))
    demod = rx._demod
    t, _ = time_r_loop(lambda x, xpc: demod(x[0], x[1], xpc),
                       (pilots, datas), rx.x_full, frames.shape[0], reps,
                       r_hi)
    return t


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5,
                    help="timing repetitions per R setting (best-of)")
    ap.add_argument("--r-hi", type=int, default=101,
                    help="repetitions of the long program")
    ap.add_argument("--batch", type=int, default=20,
                    help="device-resident frames per measurement")
    ap.add_argument("--antennas", type=int, default=16)
    ap.add_argument("--fft", type=int, default=1024)
    ap.add_argument("--symbols", type=int, default=101)
    ap.add_argument("--cells", default="composed/sc16",
                    help="comma list of PIPELINE/INPUT cells, PIPELINE in "
                         "composed|fast, INPUT in sc16|f32")
    ap.add_argument("--mesh", default=None, metavar="ANTxTIME",
                    help="bench the SHARDED receiver over an (ant, time) "
                         "device mesh (antenna-sharded MRC with one fused "
                         "psum); reports the psum payload bytes per frame")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cells = parse_cells(args.cells)

    from ofdm_ls_mrc_tpu.utils import compile_cache
    from ofdm_ls_mrc_tpu.utils.device import card_info, require_gpu

    dev = require_gpu("bench.py")
    peaks = PEAKS.get(dev["kind"])
    if peaks is None:
        raise SystemExit(f"bench.py: no published peaks for device kind "
                         f"{dev['kind']!r}; add it to PEAKS with its source")
    cache = compile_cache.enable()
    card = card_info()

    from ofdm_ls_mrc_tpu import FrameConfig

    # The chip sees CP-free symbols (the ring strips the CP on copy-out).
    cfg = FrameConfig(num_antennas=args.antennas, fft_size=args.fft,
                      cyclic_prefix=0, frame_len=args.symbols)
    rng = np.random.default_rng(args.seed)
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)
                   ).astype(np.complex64)
    frames = make_frames(cfg, args.batch, rng)
    samples = cfg.frame_len * cfg.num_antennas * cfg.fft_size

    mesh_shape = None
    if args.mesh:
        mesh_shape = tuple(int(v) for v in args.mesh.lower().split("x"))
    for pipeline, inp in cells:
        if mesh_shape:
            t0 = time.perf_counter()
            t = bench_sharded(cfg, pilot, frames, args.reps, mesh_shape,
                              pipeline=pipeline, r_hi=args.r_hi,
                              input_dtype=inp)
            compile_s = None
            setup_s = time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            t, compile_s = bench_frames(cfg, pilot, frames, args.reps,
                                        pipeline=pipeline, input_dtype=inp,
                                        r_hi=args.r_hi)
            setup_s = time.perf_counter() - t0
        nbytes = bytes_per_frame(cfg, inp)
        floor_s = nbytes / peaks["hbm_bytes_per_s"]
        rec = {
            "metric": "device_us_per_frame",
            "value": t * 1e6,
            "unit": "us",
            "cell": f"{pipeline}/{inp}",
            "geometry": f"{cfg.num_antennas}x{cfg.fft_size}x{cfg.frame_len}",
            "samples_per_s": samples / t,
            "bytes_per_frame": nbytes,
            "hbm_floor_us": floor_s * 1e6,
            "hbm_roofline_share": floor_s / t,
            "peaks_source": peaks["source"],
            "compile_s": compile_s,
            "run_s": setup_s,
            "frames_resident": args.batch,
            "r_hi": args.r_hi,
            "device": {k: dev[k] for k in ("platform", "kind", "count")},
            "xla_flags": dev["xla_flags"],
            "card": card,
            "compile_cache": cache,
        }
        if mesh_shape:
            rec["mesh"] = args.mesh
            rec["psum_payload_bytes_per_frame"] = psum_payload_bytes(
                cfg, mesh_shape[1])
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
