"""Native shm-ring ingest throughput: producer process -> consumer process.

The ingest side of the real-time budget: how fast symbols move through the
POSIX shm ring including the consumer-side CP-drop + planar deinterleave
(and sc16->float conversion when --dtype sc16).  The reference's analogue is
its per-symbol read timer (ShMemSymBuff.hpp:150).  Prints one JSON line.

Run:  python tools/ring_bench.py --antennas 16 --fft 1024 --cp 72 --dtype sc16
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import time
import uuid

import numpy as np

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))


def _producer(uid, rows, cols, length, n, dtype, batch_write):
    from ofdm_ls_mrc_tpu.io.ring import SymbolRing

    w = SymbolRing(uid, rows, cols, length, master=True, timeout=60.0,
                   dtype=dtype)
    rng = np.random.default_rng(0)
    if dtype == "sc16":
        sym = rng.integers(-30000, 30000, size=(rows, 2 * cols), dtype=np.int16)
    else:
        sym = (rng.standard_normal((rows, cols))
               + 1j * rng.standard_normal((rows, cols))).astype(np.complex64)
    if batch_write:
        # One native call per frame-sized burst (rx_app's writer shape:
        # many symbols extracted per radio recv buffer).
        chunk = np.broadcast_to(sym, (length - 1,) + sym.shape)
        chunk = np.ascontiguousarray(chunk)
        left = n
        while left > 0:
            m = min(left, length - 1)
            w.write_batch(chunk[:m], wait=True, timeout=60.0)
            left -= m
    else:
        for _ in range(n):
            w.write(sym, wait=True, timeout=60.0)
    w.wait_drained(60.0)
    w.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--antennas", type=int, default=16)
    ap.add_argument("--fft", type=int, default=1024)
    ap.add_argument("--cp", type=int, default=72)
    ap.add_argument("--len", type=int, default=101, dest="length")
    ap.add_argument("--symbols", type=int, default=20000)
    ap.add_argument("--dtype", default="complex64", choices=["complex64", "sc16"])
    ap.add_argument("--batch", action="store_true",
                    help="consume via the one-call-per-frame batch read")
    ap.add_argument("--i16", action="store_true",
                    help="sc16-native consumer: planar int16 copy-out "
                         "without float conversion (read_frame_planar_i16; "
                         "requires --dtype sc16 and --batch)")
    ap.add_argument("--batch-write", action="store_true",
                    help="producer writes frame-sized bursts via the one-call "
                         "write_batch (the rx_app writer shape) instead of "
                         "one native call per symbol")
    ap.add_argument("--decompose", action="store_true",
                    help="single-process write-leg/read-leg split instead of "
                         "the concurrent end-to-end number: alternately fill "
                         "and drain one ring, timing each leg (the PERF.md "
                         "'host ring ingest profile' decomposition)")
    args = ap.parse_args()
    if args.i16 and (args.dtype != "sc16" or not args.batch):
        raise SystemExit("--i16 requires --dtype sc16 --batch")

    from ofdm_ls_mrc_tpu.io.ring import SymbolRing

    if args.decompose:
        return _decompose(args, SymbolRing)

    cols = args.fft + args.cp
    uid = f"/ringbench_{uuid.uuid4().hex[:8]}"
    ctx = mp.get_context("spawn")
    p = ctx.Process(target=_producer, args=(uid, args.antennas, cols,
                                            args.length, args.symbols,
                                            args.dtype, args.batch_write))
    p.start()
    r = SymbolRing(uid, args.antennas, cols, args.length, master=False,
                   timeout=60.0, dtype=args.dtype)
    # Warm both sides, then time steady-state reads.
    r.read_next_planar(cp=args.cp)
    n_timed = args.symbols - 1
    t0 = time.perf_counter()
    if args.batch:
        keep = cols - args.cp
        buf_dt = np.int16 if args.i16 else np.float32
        bre = np.empty((args.length, args.antennas, keep), buf_dt)
        bim = np.empty_like(bre)
        read = r.read_frame_planar_i16 if args.i16 else r.read_frame_planar
        left = n_timed
        while left > 0:
            chunk = min(left, args.length)
            read(chunk, cp=args.cp, out_re=bre[:chunk], out_im=bim[:chunk])
            left -= chunk
    else:
        for _ in range(n_timed):
            r.read_next_planar(cp=args.cp)
    dt = time.perf_counter() - t0
    p.join(timeout=60)
    r.close()

    sps = (args.symbols - 1) / dt
    elem = 4 if args.dtype == "sc16" else 8
    gbps = sps * args.antennas * cols * elem / 1e9
    print(json.dumps({
        "metric": f"ring_symbols_per_sec[{args.dtype}]",
        "value": round(sps, 1),
        "unit": "symbols/s",
        "shm_GB_per_s": round(gbps, 2),
        "geometry": f"{args.antennas}x{cols}x{args.length}",
    }))
    return 0


def _decompose(args, SymbolRing):
    """Alternate fill/drain passes over one ring in one process, timing the
    write leg and the prealloc batch-read leg separately (steady-state: the
    last passes, after shm pages and buffers are warm).  The end-to-end
    `--batch` number minus these legs is producer/consumer cache-coherence
    contention."""
    cols = args.fft + args.cp
    keep = cols - args.cp
    uid = f"/ringdec_{uuid.uuid4().hex[:8]}"
    w = SymbolRing(uid, args.antennas, cols, args.length, master=True,
                   timeout=60.0, dtype=args.dtype)
    r = SymbolRing(uid, args.antennas, cols, args.length, master=False,
                   timeout=60.0, dtype=args.dtype)
    rng = np.random.default_rng(0)
    if args.dtype == "sc16":
        sym = rng.integers(-30000, 30000,
                           size=(args.antennas, 2 * cols), dtype=np.int16)
    else:
        sym = (rng.standard_normal((args.antennas, cols))
               + 1j * rng.standard_normal((args.antennas, cols))
               ).astype(np.complex64)
    n = args.length - 1  # leave one slot free: wait-mode writes never block
    buf_dt = np.int16 if args.i16 else np.float32
    bre = np.empty((n, args.antennas, keep), buf_dt)
    bim = np.empty_like(bre)
    read = r.read_frame_planar_i16 if args.i16 else r.read_frame_planar
    batch = np.ascontiguousarray(np.broadcast_to(sym, (n,) + sym.shape))
    tw = twb = tr = None
    for _ in range(4):  # first passes warm shm pages; keep the last
        t0 = time.perf_counter()
        for _ in range(n):
            w.write(sym, wait=True, timeout=60.0)
        tw = (time.perf_counter() - t0) / n
        read(n, cp=args.cp, out_re=bre, out_im=bim)  # drain
        t0 = time.perf_counter()
        w.write_batch(batch, wait=True, timeout=60.0)
        twb = (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        read(n, cp=args.cp, out_re=bre, out_im=bim)
        tr = (time.perf_counter() - t0) / n
    w.close()
    r.close()
    elem = 4 if args.dtype == "sc16" else 8
    sz = args.antennas * cols * elem
    print(json.dumps({
        "metric": f"ring_leg_us_per_symbol[{args.dtype}]",
        "write_us": round(tw * 1e6, 1),
        "write_batch_us": round(twb * 1e6, 1),
        "read_prealloc_us": round(tr * 1e6, 1),
        "write_GB_per_s": round(sz / tw / 1e9, 2),
        "write_batch_GB_per_s": round(sz / twb / 1e9, 2),
        "read_GB_per_s": round(sz / tr / 1e9, 2),
        "geometry": f"{args.antennas}x{cols}x{args.length}",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
