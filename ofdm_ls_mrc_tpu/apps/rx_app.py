"""RX ingest process: IQ source -> PN frame sync -> shm ring (master).

The hardware-free replacement for the reference's UHD receive app
(rx_and_corr.cpp:89-437): keeps its CLI surface (--rate/--freq/--gain/
--channels/--frame-size/--thres/--cp-size, rx_and_corr.cpp:100-121), its PN
sliding-correlator frame synchronization (rx_and_corr.cpp:332-360), its
double-buffered stitch (rx_and_corr.cpp:372-393) and its ring-master role
(mode 1, rx_and_corr.cpp:52) -- but sources samples from an IQ capture file
or the built-in channel simulator instead of a USRP.

Run:  python -m ofdm_ls_mrc_tpu.apps.rx_app --file capture.dat --antennas 16 \\
          --fft-size 1024 --cp-size 72 --frame-len 101
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    # Reference CLI surface (rx_and_corr.cpp:100-121; hardware params
    # validated and logged per channel; no UHD here).  rate/freq/gain/bw
    # accept per-channel comma lists; scalars broadcast like the reference.
    ap.add_argument("--rate", default="1e6", help="sample rate (sps), scalar "
                    "or per-channel comma list")
    ap.add_argument("--freq", default="0.0", help="RF center frequency (Hz), "
                    "scalar or per-channel comma list")
    ap.add_argument("--gain", default="0.0", help="RF gain (dB), scalar or "
                    "per-channel comma list")
    ap.add_argument("--bw", default="0.0", help="analog frontend bandwidth "
                    "(Hz), scalar or per-channel comma list")
    ap.add_argument("--ant", default=None, help="antenna selection "
                    "(rx_and_corr.cpp:193-195; informational)")
    ap.add_argument("--sync", default="now", choices=["now", "pps", "mimo"],
                    help="clock sync method (rx_and_corr.cpp:237-260; "
                         "informational)")
    ap.add_argument("--channels", default=None,
                    help="capture row(s) to use, e.g. '0' or '0,2' "
                         "(rx_and_corr.cpp:113-114); default: all rows.  "
                         "Selected rows become the ring's antenna rows and "
                         "the per-channel dump set")
    ap.add_argument("--frame-size", type=int, default=1024,
                    help="samples per receive buffer (num_samps)")
    ap.add_argument("--thres", type=float, default=0.1,
                    help="PN correlator threshold")
    ap.add_argument("--cp-size", type=int, default=72)
    ap.add_argument("--file-prefix", default="corr_rec",
                    help="prefix for aligned/raw capture dumps")
    # Framework-specific source + ring config.
    ap.add_argument("--file", default=None,
                    help="IQ capture: complex64 binary, [antennas, samples] "
                         "C-order (or 1-D for one antenna)")
    ap.add_argument("--pn-file", default="PNSeq_255_MaxLenSeq.dat")
    ap.add_argument("--no-sync", action="store_true",
                    help="skip PN correlation; treat input as frame-aligned")
    ap.add_argument("--continuous-sync", action="store_true",
                    help="correlate EVERY receive buffer and re-acquire after "
                         "drift/gaps/slips instead of syncing once (the "
                         "reference receive loop, rx_and_corr.cpp:305-405); "
                         "requires the PN before every frame (tx_app "
                         "--pn-every-frame); aligned frames are written to "
                         "the ring from a producer thread")
    ap.add_argument("--antennas", type=int, default=16)
    ap.add_argument("--fft-size", type=int, default=1024)
    ap.add_argument("--frame-len", type=int, default=101,
                    help="symbols per frame incl. pilot")
    ap.add_argument("--shm-uid", default="/ofdm_ring")
    ap.add_argument("--num-frames", type=int, default=1,
                    help="frames to stream; 0 = continuous file-player mode "
                         "(cycle the capture until SIGINT/reader shutdown)")
    ap.add_argument("--wait-writes", action="store_true",
                    help="backpressured writes (default: no-wait like live RX)")
    ap.add_argument("--dump-aligned", action="store_true",
                    help="dump aligned captures per channel like the reference")
    ap.add_argument("--dump-raw", action="store_true",
                    help="dump the raw pre-sync capture per channel (the "
                         "reference's raw ring-capture dump, "
                         "rx_and_corr.cpp:411-427)")
    ap.add_argument("--file-format", default="cf32",
                    choices=["cf32", "sc16"],
                    help="capture file sample format: cf32 = complex64, "
                         "sc16 = interleaved int16 IQ (USRP wire format)")
    ap.add_argument("--ring-dtype", default="complex64",
                    choices=["complex64", "sc16"],
                    help="shm element format; sc16 halves ring bandwidth "
                         "(USRP wire format)")
    ap.add_argument("--timeout", type=float, default=30.0)
    return ap


def _make_pacer(period: float):
    """Absolute-deadline pacer: one call per emitted unit, drift-free.
    A radio delivers samples at --rate; an unthrottled file-player overruns
    ANY consumer by construction, so the live no-wait modes pace writes."""
    if period <= 0:
        return lambda: None
    import time as _time
    state = {"next": _time.perf_counter()}

    def tick():
        state["next"] += period
        delay = state["next"] - _time.perf_counter()
        if delay > 0:
            _time.sleep(delay)
    return tick


def load_capture(path: str, antennas: int, fmt: str = "cf32") -> np.ndarray:
    if fmt == "sc16":
        from ..golden.io import sc16_to_complex
        raw = sc16_to_complex(np.fromfile(path, dtype=np.int16))
    else:
        raw = np.fromfile(path, dtype=np.complex64)
    if antennas == 1:
        return raw.reshape(1, -1)
    if raw.size % antennas:
        raise ValueError(f"{path}: {raw.size} samples not divisible by "
                         f"{antennas} antennas")
    return raw.reshape(antennas, -1)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..golden.io import load_pn_sequence
    from ..io.ring import RingShutdown, SymbolRing
    from ..sim.pn import correlate_frame_start
    from ._cli import log_channel_config, parse_channels, per_channel

    if args.file is None:
        print("no --file given: nothing to play", file=sys.stderr)
        return 2
    if args.continuous_sync and (args.dump_aligned or args.dump_raw):
        # Fail loud before any IO: the rolling loop consumes buffers as it
        # goes and keeps no whole aligned capture to dump.
        print("--dump-aligned/--dump-raw are one-shot-sync features "
              "(not --continuous-sync)", file=sys.stderr)
        return 2

    samples = load_capture(args.file, args.antennas, args.file_format)  # [A, N]
    # Per-channel configuration: the reference loops the channel list
    # applying rate/freq/gain/bw/ant to each (rx_and_corr.cpp:157-198);
    # here the selected channels become the capture rows used.
    chan_ids = parse_channels(args.channels, samples.shape[0])
    n_ch = len(chan_ids)
    rates = per_channel(args.rate, n_ch, "--rate")
    log_channel_config("RX", chan_ids, rates,
                       per_channel(args.freq, n_ch, "--freq"),
                       per_channel(args.gain, n_ch, "--gain"),
                       per_channel(args.bw, n_ch, "--bw"), args.ant)
    samples = samples[chan_ids]
    sym_len = args.fft_size + args.cp_size
    frame_samps = args.frame_len * sym_len

    if args.continuous_sync:
        return _run_continuous_sync(args, samples, sym_len, frame_samps,
                                    chan_ids, rates[0])

    # Frame synchronization: slide the PN correlator over antenna 0 (the
    # reference scans channels in order and stops at the first hit,
    # rx_and_corr.cpp:333-359).
    if args.no_sync:
        start = 0
    else:
        pn = load_pn_sequence(args.pn_file)
        start, peak = correlate_frame_start(samples[0], pn, args.thres)
        if start < 0:
            print(f"no PN peak above thres={args.thres} (max {peak:.4f})",
                  file=sys.stderr)
            return 1
        print(f"PN sync: start={start} peak={peak:.4f}")
        start += pn.size  # payload begins after the preamble

    ring = SymbolRing(args.shm_uid, n_ch, sym_len, args.frame_len,
                      master=True, timeout=args.timeout, dtype=args.ring_dtype)
    print(f"ring master up: uid={args.shm_uid} "
          f"[{n_ch} x {sym_len}] x {args.frame_len}")

    # --num-frames 0: continuous file-player mode -- cycle the capture until
    # SIGINT or reader shutdown (the reference RX runs `while !stop_signal`,
    # rx_and_corr.cpp:296,305).
    avail_frames = (samples.shape[1] - start) // frame_samps
    if avail_frames < 1:
        print("capture shorter than one frame after sync", file=sys.stderr)
        ring.close()
        return 1
    continuous = args.num_frames <= 0

    pace = _make_pacer(frame_samps / rates[0]
                       if (continuous and not args.wait_writes
                           and rates[0] > 0) else 0.0)

    wrote = 0
    frames_sent = 0

    def write_dumps():
        # Runs on EVERY exit path (finally below): continuous mode only
        # leaves the loop via SIGINT/RingShutdown, and the reference dumps
        # its captures after the stream stops (rx_and_corr.cpp:411-427).
        if args.dump_aligned:
            dump_frames = min(frames_sent, avail_frames)  # continuous cycles
            for i, ch in enumerate(chan_ids):     # per-channel dumps, named
                out = f"{args.file_prefix}_ch_{ch}_binary"   # by channel id
                samples[i, start:start + dump_frames * frame_samps].tofile(out)
        if args.dump_raw:
            for i, ch in enumerate(chan_ids):
                samples[i].tofile(f"{args.file_prefix}_raw_ch_{ch}_binary")

    try:
        f = 0
        while continuous or f < args.num_frames:
            pace()
            base = start + (f % avail_frames if continuous else f) * frame_samps
            if not continuous and base + frame_samps > samples.shape[1]:
                print(f"capture exhausted after {f} frame(s)")
                break
            fr = samples[:, base: base + frame_samps]
            burst = np.ascontiguousarray(
                fr.reshape(n_ch, args.frame_len, sym_len).transpose(1, 0, 2))
            wrote += ring.write_batch(burst, wait=args.wait_writes,
                                      timeout=args.timeout)
            frames_sent += 1
            f += 1
        print(f"wrote {wrote} symbols ({frames_sent} frame(s)), "
              f"dropped={ring.dropped}")
    except KeyboardInterrupt:
        print(f"SIGINT: stopping after {frames_sent} frame(s), "
              f"{wrote} symbols, dropped={ring.dropped}")
    except RingShutdown:
        print(f"reader shut the ring down after {frames_sent} frame(s)")
    finally:
        write_dumps()
        # Teardown handshake: wait for the slave to drain before unlinking
        # the segment (the reference's destructor sentinel dance,
        # ShMemSymBuff.hpp:221-230, minus the infinite spin).
        if not ring.wait_drained(args.timeout):
            print("warning: reader did not drain the ring before timeout",
                  file=sys.stderr)
        ring.close()
    return 0


def _run_continuous_sync(args, samples: np.ndarray, sym_len: int,
                         frame_samps: int, chan_ids=None,
                         rate0: float = 0.0) -> int:
    """Rolling receive loop: chunk the capture into receive buffers, push
    each through the StreamSynchronizer (correlating every buffer, stitching
    frames across buffer boundaries, re-acquiring after slips), and write
    aligned frames into the ring from a producer thread -- the reference's
    recv -> correlate -> stitch -> boost::thread(copy_to_shared_mem)
    structure (rx_and_corr.cpp:305-405)."""
    import queue
    import threading

    from ..golden.io import load_pn_sequence
    from ..io.ring import RingShutdown, SymbolRing
    from ..sim.sync import StreamSynchronizer

    n_ch = samples.shape[0]
    pn = load_pn_sequence(args.pn_file)
    sync = StreamSynchronizer(pn, frame_samps, args.thres)
    ring = SymbolRing(args.shm_uid, n_ch, sym_len, args.frame_len,
                      master=True, timeout=args.timeout, dtype=args.ring_dtype)
    print(f"ring master up: uid={args.shm_uid} "
          f"[{n_ch} x {sym_len}] x {args.frame_len} "
          f"(continuous sync, buffer={args.frame_size})")

    q: "queue.Queue" = queue.Queue(maxsize=8)
    state = {"written": 0, "err": None}

    def writer():
        try:
            while True:
                fr = q.get()
                if fr is None:
                    return
                # [n_ch, S*L] -> [S, n_ch, L] burst; ONE native call per
                # frame (write_batch) instead of one per symbol -- per-call
                # overhead is the write leg's dominant cost.
                burst = np.ascontiguousarray(
                    fr.reshape(n_ch, args.frame_len, sym_len).transpose(1, 0, 2))
                state["written"] += ring.write_batch(
                    burst, wait=args.wait_writes, timeout=args.timeout)
        except RingShutdown:
            state["err"] = "reader shut the ring down"
        except BaseException as e:  # surface ring errors to the main thread
            state["err"] = e

    th = threading.Thread(target=writer, daemon=True)
    th.start()

    def enqueue(item) -> bool:
        """Bounded put that never deadlocks: gives up (False) once the
        writer thread has died (ring shutdown/timeout), since nothing will
        ever drain the queue again."""
        while state["err"] is None:
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    continuous = args.num_frames <= 0
    buf_len = max(args.frame_size, 1)
    # Continuous no-wait mode paces receive buffers to --rate, like the
    # file-player loop.
    pace = _make_pacer(buf_len / rate0
                       if (continuous and not args.wait_writes and rate0 > 0)
                       else 0.0)
    n_total = samples.shape[1]
    pos = 0
    sent = 0
    try:
        while (continuous or sent < args.num_frames) and state["err"] is None:
            pace()
            if pos >= n_total:
                if not continuous:
                    for fr in sync.flush():
                        if sent < args.num_frames and enqueue(fr):
                            sent += 1
                    break
                pos = 0  # file-player mode cycles the capture
            chunk = samples[:, pos:pos + buf_len]
            pos += buf_len
            for fr in sync.push(chunk):
                if not continuous and sent >= args.num_frames:
                    break
                if not enqueue(fr):
                    break
                sent += 1
    except KeyboardInterrupt:
        print(f"SIGINT: stopping after {sent} frame(s)")
    enqueue(None)
    th.join(timeout=args.timeout)
    print(f"continuous sync: {sent} frame(s) ({state['written']} symbols), "
          f"resyncs={sync.resyncs} drift_corrections={sync.drift_corrections} "
          f"dropped={ring.dropped}")
    if state["err"] not in (None, "reader shut the ring down"):
        print(f"writer error: {state['err']}", file=sys.stderr)
    if not ring.wait_drained(args.timeout):
        print("warning: reader did not drain the ring before timeout",
              file=sys.stderr)
    ring.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
