"""One-command sustained-pressure soak of the three-process topology.

A reproducible pass/fail run of the live topology under overrun pressure:
tx_app generates a PN-preambled capture, rx_app loops it as a rate-paced
continuous ring producer (no-wait writes, like live RX), and
demod_app consumes in catch-up mode until the deadline; then the demodulated
output is scored per frame against the sent constellation grid using the
frame-provenance index (clean frames gate the EVM threshold; best-effort
dirty frames are reported separately).  This is the reference's production
shape -- rx_and_corr.cpp writing while cpuLS/gpuLS drains -- driven to a
machine-readable verdict.

With --num-frames N > 1 the producer cycles N distinct frames and each
delivered block is scored against its OWN sent grid via the index's
writer-seq column -- proving the provenance mapping holds under catch-up
skips and overrun drops, not just that one repeated frame demodulates.

With --frames N the run ends once the consumer has delivered N frames
(--seconds then only caps it), so its length is a frame count, not a
wall-clock window that a busy host fills with more or fewer frames.

Usage:
  python tools/soak.py --seconds 30                      # defaults: 4x64 CPU-sized
  python tools/soak.py --frames 6 --seconds 120          # count-bounded
  python tools/soak.py --seconds 120 --antennas 16 --fft-size 1024 \
      --frame-len 101 --ring-dtype sc16 --sc16-native --rate 4e6   # on a GPU

Prints one JSON line and exits 0 iff enough clean frames demodulated under
the EVM bound.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
import uuid

import numpy as np

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seconds", type=float, default=30.0,
                    help="producer run time before SIGINT (with --frames: "
                         "the cap on it)")
    ap.add_argument("--frames", type=int, default=0,
                    help="end the run once the consumer has delivered this "
                         "many frames (0: run for --seconds)")
    ap.add_argument("--antennas", type=int, default=4)
    ap.add_argument("--fft-size", type=int, default=64)
    ap.add_argument("--cp-size", type=int, default=8)
    ap.add_argument("--frame-len", type=int, default=9)
    ap.add_argument("--rate", default="1e6",
                    help="producer pacing (samples/s; live-RX shape)")
    ap.add_argument("--snr", default="40", help="channel sim SNR (dB)")
    ap.add_argument("--channel-taps", default="4")
    ap.add_argument("--modulation", default="16qam")
    ap.add_argument("--num-frames", type=int, default=1,
                    help="distinct transmitted frames the producer cycles; "
                         "each delivered frame is scored against ITS OWN "
                         "sent grid via the writer-seq provenance column")
    ap.add_argument("--ring-dtype", default="cf32", choices=["cf32", "sc16"])
    ap.add_argument("--consumer", default="whole-frame",
                    choices=["whole-frame", "per-symbol"],
                    help="whole-frame: catch-up RingFeed consumer under a "
                         "no-wait producer (overrun pressure).  per-symbol: "
                         "the reference's main runtime loop (firstVector + "
                         "demodOneSymbol, cpuLS_main.cpp:80-93) under a "
                         "BACKPRESSURED producer (--wait-writes, the "
                         "writeNextSymbolWithWait shape); requires "
                         "--num-frames 1 (no provenance index in this mode: "
                         "all output rows score against the one sent grid)")
    ap.add_argument("--continuous-sync", action="store_true",
                    help="producer runs the rolling receive loop (per-buffer "
                         "PN correlate / cross-buffer stitch / re-acquire, "
                         "the reference rx_and_corr.cpp:305-405 shape) "
                         "instead of one-shot sync; the TX capture gets a PN "
                         "before EVERY frame.  Requires --num-frames 1: the "
                         "capture-cycle discontinuity re-acquires mid-stream, "
                         "which breaks the writer-seq -> sent-grid mapping "
                         "for distinct frames")
    ap.add_argument("--sc16-native", action="store_true",
                    help="consumer keeps int16 end to end (widened on the "
                         "device)")
    ap.add_argument("--distributed", type=int, default=0, metavar="N",
                    help="run the ANTENNA-ACROSS-HOSTS topology: the "
                         "capture splits into N per-host antenna blocks, "
                         "each with its own rx_app producer ring, and N "
                         "demod_app --distributed consumers demodulate in "
                         "lockstep over jax.distributed (rank 0 writes the "
                         "output + merged provenance index scored below).  "
                         "Requires --antennas divisible by N")
    ap.add_argument("--mesh", default=None, metavar="ANTxTIME",
                    help="consumer demodulates on a sharded mesh")
    ap.add_argument("--pipeline", default=None, choices=["composed", "fast"],
                    help="consumer pipeline override")
    ap.add_argument("--evm-db", type=float, default=-25.0,
                    help="per-clean-frame EVM bound (dB)")
    ap.add_argument("--min-frames", type=int, default=2,
                    help="fail if fewer clean frames demodulated")
    ap.add_argument("--dir", default=None,
                    help="work directory (default: a fresh temp dir)")
    ap.add_argument("--pilots", default="SoakPilots.dat",
                    help="pilot file (missing -> both apps use the same "
                         "deterministic fallback, cpuLS.hpp:84-90 semantics)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the work directory")
    ap.add_argument("--timeout", default="60",
                    help="ring spin deadline passed to both apps")
    return ap


def _spawn(mod, args, env, log_base):
    # Redirect to files, not PIPEs: a paced soak can emit thousands of
    # per-event stderr lines (RingFeed drop notices) and an undrained pipe
    # fills at ~64 KB, wedging the child mid-soak -- the verdict would then
    # measure a blocked consumer, not the configured pressure.
    out_f = open(log_base + ".out", "w+")
    err_f = open(log_base + ".err", "w+")
    p = subprocess.Popen([sys.executable, "-m", mod] + args, cwd=REPO,
                         env=env, stdout=out_f, stderr=err_f, text=True)
    p._soak_logs = (out_f, err_f)
    return p


def _finish(p, timeout, interrupt=False):
    """Wait for a child (escalating SIGINT->SIGKILL) and return its logs."""
    try:
        p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        if interrupt:
            p.send_signal(signal.SIGINT)
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        else:
            p.kill()
            p.wait()
    out_f, err_f = p._soak_logs
    texts = []
    for fh in (out_f, err_f):
        fh.flush()
        fh.seek(0)
        texts.append(fh.read())
        fh.close()
    return texts


def _delivered(out: str, frame_len: int, per_symbol: bool) -> int:
    """Frames the consumer has delivered so far: provenance-index lines
    (whole-frame consumers) or complete output frames (per-symbol)."""
    try:
        if per_symbol:
            return os.path.getsize(out) // (8 * (frame_len - 1))
        with open(out + ".index") as fh:
            return sum(1 for ln in fh if ln.endswith("\n"))
    except OSError:
        return 0


def _first_failure(codes) -> int:
    """The first nonzero exit code among ``codes``, else 0."""
    return next((c for c in codes if c != 0), 0)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.continuous_sync and args.num_frames != 1:
        print("--continuous-sync requires --num-frames 1 (re-acquisition "
              "after the capture-cycle discontinuity breaks per-frame "
              "attribution of distinct sent grids)", file=sys.stderr)
        return 2
    per_symbol = args.consumer == "per-symbol"
    if per_symbol and args.num_frames != 1:
        print("--consumer per-symbol requires --num-frames 1 (that mode "
              "has no provenance index; scoring needs one sent grid)",
              file=sys.stderr)
        return 2
    if args.sc16_native and args.ring_dtype != "sc16":
        print("--sc16-native requires --ring-dtype sc16", file=sys.stderr)
        return 2
    if args.distributed and (per_symbol or args.mesh):
        print("--distributed composes with the whole-frame consumer "
              "(not --consumer per-symbol/--mesh)", file=sys.stderr)
        return 2
    if per_symbol and args.mesh and args.mesh.lower().split("x")[-1] != "1":
        # demod_app gates this too; fail here before spawning processes.
        print("--consumer per-symbol shards over the ant axis only "
              "(ANTx1 mesh -- parallel/streaming.py)", file=sys.stderr)
        return 2
    workdir = args.dir or os.path.join(
        "/tmp", f"ofdm_soak_{uuid.uuid4().hex[:8]}")
    os.makedirs(workdir, exist_ok=True)
    cap = os.path.join(workdir, "capture.dat")
    sent_path = os.path.join(workdir, "sent.dat")
    out = os.path.join(workdir, "Output_gpu.dat")
    uid = f"/ofdm_soak_{uuid.uuid4().hex[:8]}"
    pp = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([REPO] + pp)}
    # Only the consumer may open the card: a JAX process reserves most of
    # it, so the producers (which import no JAX backend) are pinned to the
    # CPU platform as well.
    cpu_env = {**env, "JAX_PLATFORMS": "cpu"}

    geom = ["--antennas", str(args.antennas), "--fft-size", str(args.fft_size),
            "--cp-size", str(args.cp_size), "--frame-len", str(args.frame_len)]
    sc16 = args.ring_dtype == "sc16"

    # 1. The sent frames; the producer cycles them.  With --num-frames 1
    #    every delivered frame scores against the same grid; with N > 1 the
    #    index's writer-seq column maps each delivered frame to sent grid
    #    (wseq mod N) even across catch-up skips and overrun drops.
    pn_mode = "--pn-every-frame" if args.continuous_sync else "--pn-preamble"
    tx = subprocess.run(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap,
         "--data-out", sent_path, pn_mode, "--snr", args.snr,
         "--channel-taps", args.channel_taps, "--modulation", args.modulation,
         "--pilots", args.pilots, "--num-frames", str(args.num_frames)]
        + (["--out-format", "sc16"] if sc16 else []) + geom,
        cwd=REPO, env=cpu_env, capture_output=True, text=True, timeout=300)
    if tx.returncode != 0:
        print(tx.stderr, file=sys.stderr)
        return 2

    ring = ["--ring-dtype", args.ring_dtype] if sc16 else []
    dm_extra = []
    if args.sc16_native:
        dm_extra += ["--sc16-native"]
    if args.mesh:
        dm_extra += ["--mesh", args.mesh]
    if args.pipeline:
        dm_extra += ["--pipeline", args.pipeline]
    if args.distributed:
        # Antenna-across-hosts: split the capture's antenna rows into N
        # per-host blocks, each with its own rx_app producer + ring; N
        # demod_app --distributed consumers run lockstep over a local
        # jax.distributed coordinator.  Rank 0 writes output + index.
        import socket
        nproc = args.distributed
        if args.antennas % nproc:
            print(f"--distributed {nproc}: {args.antennas} antennas not "
                  f"divisible", file=sys.stderr)
            return 2
        a_local = args.antennas // nproc
        # Capture layout is row-major per antenna for both formats (sc16
        # int16 IQ interleaves WITHIN a row), so the split is a row slice.
        dt = np.int16 if sc16 else np.complex64
        rows = np.fromfile(cap, dtype=dt).reshape(args.antennas, -1)
        host_caps = []
        for i in range(nproc):
            p = os.path.join(workdir, f"capture_h{i}.dat")
            rows[i * a_local:(i + 1) * a_local].tofile(p)
            host_caps.append(p)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        geom_local = ["--antennas", str(a_local), "--fft-size",
                      str(args.fft_size), "--cp-size", str(args.cp_size),
                      "--frame-len", str(args.frame_len)]
        rxs = [_spawn("ofdm_ls_mrc_tpu.apps.rx_app",
                      ["--file", host_caps[i], "--shm-uid", f"{uid}_{i}",
                       "--num-frames", "0", "--rate", args.rate,
                       "--thres", "0.05", "--timeout", args.timeout]
                      + (["--continuous-sync"] if args.continuous_sync
                         else [])
                      + (["--file-format", "sc16"] if sc16 else [])
                      + ring + geom_local,
                      cpu_env, os.path.join(workdir, f"rx{i}"))
               for i in range(nproc)]
        dms = [_spawn("ofdm_ls_mrc_tpu.apps.demod_app",
                      ["--distributed", f"127.0.0.1:{port}",
                       "--num-processes", str(nproc), "--process-id",
                       str(i), "--shm-uid", f"{uid}_{i}", "--output", out,
                       "--num-frames", "0", "--no-timer", "--catch-up",
                       "--pilots", args.pilots, "--timeout", args.timeout]
                      + ring + dm_extra + geom,
                      env, os.path.join(workdir, f"demod{i}"))
               for i in range(nproc)]
    else:
        rxs = [_spawn("ofdm_ls_mrc_tpu.apps.rx_app",
                      ["--file", cap, "--shm-uid", uid, "--num-frames", "0",
                       "--rate", args.rate, "--thres", "0.05",
                       "--timeout", args.timeout]
                      + (["--continuous-sync"] if args.continuous_sync
                         else [])
                      + (["--wait-writes"] if per_symbol else [])
                      + (["--file-format", "sc16"] if sc16 else [])
                      + ring + geom,
                      cpu_env, os.path.join(workdir, "rx"))]
        # per-symbol: the reference's per-symbol runtime loop against a
        # BACKPRESSURED producer (writeNextSymbolWithWait semantics) -- no
        # overruns, no RingFeed, no provenance index.
        dm_mode = (["--per-symbol"] if per_symbol else ["--catch-up"])
        dms = [_spawn("ofdm_ls_mrc_tpu.apps.demod_app",
                      ["--shm-uid", uid, "--output", out, "--num-frames",
                       "0", "--no-timer", "--pilots", args.pilots,
                       "--timeout", args.timeout] + dm_mode + ring
                      + dm_extra + geom,
                      env, os.path.join(workdir, "demod"))]
    rx, dm = rxs[0], dms[0]

    # --seconds measures STEADY-STATE pressure: start the countdown once the
    # consumer has demodulated its first frame (the provenance index flushes
    # per frame), not while it is still importing/compiling -- a cold JAX
    # start can exceed a short soak window entirely.  Bounded by --timeout.
    warm_deadline = time.time() + float(args.timeout)
    while time.time() < warm_deadline:
        if any(p.poll() is not None for p in rxs + dms):
            break
        first_out = out if per_symbol else out + ".index"
        if os.path.exists(first_out) and os.path.getsize(first_out):
            break
        time.sleep(0.2)
    deadline = time.time() + args.seconds
    while time.time() < deadline:
        if any(p.poll() is not None for p in rxs + dms):
            break          # early death: report below instead of hanging
        if args.frames and _delivered(out, args.frame_len,
                                      per_symbol) >= args.frames:
            break
        time.sleep(0.2)
    for p in rxs:
        if p.poll() is None:
            p.send_signal(signal.SIGINT)  # master drains + shutdown sentinel
    rx_out, rx_err = _finish(rx, timeout=120)
    for p in rxs[1:]:
        ro, re_ = _finish(p, timeout=120)
        rx_out, rx_err = rx_out + ro, rx_err + re_
    # Distributed consumers end on the lockstep END sentinel once every
    # ring shuts down; SIGINT only as the escalation fallback.
    dm_out, dm_err = _finish(dm, timeout=300, interrupt=True)
    for p in dms[1:]:
        do, de = _finish(p, timeout=300, interrupt=True)
        dm_out, dm_err = dm_out + do, dm_err + de

    # 2. Score per delivered frame, keyed by the provenance index.  The
    #    5th column (writer-stream frame ordinal) selects WHICH sent grid a
    #    block is compared against when the producer cycles several frames.
    f, s = args.fft_size, args.frame_len
    nsent = args.num_frames
    sent = np.fromfile(sent_path, dtype=np.complex64).reshape(
        nsent, s - 1, f - 1)
    rows = (np.fromfile(out, dtype=np.complex64) if os.path.exists(out)
            else np.zeros(0, np.complex64))
    rows = rows[: rows.size // (f - 1) * (f - 1)].reshape(-1, f - 1)
    statuses = []
    try:
        with open(out + ".index") as idx:
            statuses = [ln.split() for ln in idx if ln.strip()]
    except OSError:
        pass

    def frame_evm(block, ref):
        got = np.fft.fftshift(block, axes=-1)
        return float(10 * np.log10(
            np.mean(np.abs(got - ref) ** 2)
            / np.mean(np.abs(ref) ** 2) + 1e-30))

    evm_clean, evm_dirty = [], []
    for p in statuses:
        if len(p) < 4:
            continue   # truncated final line (consumer killed mid-write)
        seq, status, lo, hi = p[:4]
        wseq = int(p[4]) if len(p) > 4 else -1
        lo, hi = int(lo), int(hi)
        if lo < 0 or hi > len(rows):
            continue
        if wseq < 0:
            if nsent > 1:
                continue            # can't attribute: don't mis-score
            wseq = 0
        (evm_clean if status == "clean" else evm_dirty).append(
            frame_evm(rows[lo:hi], sent[wseq % nsent]))
    if not statuses and len(rows) and nsent == 1:
        # No index: treat all rows as clean (single sent grid only).
        evm_clean = [frame_evm(rows[i:i + s - 1], sent[0])
                     for i in range(0, len(rows) - (s - 2), s - 1)]

    overruns = {}
    for ln in (dm_err or "").splitlines():
        if "writer overruns" in ln:
            overruns = {"raw": ln.strip()}
    for ln in (rx_out or "").splitlines():
        if ln.startswith("continuous sync:"):   # producer-side sync summary
            overruns["producer_sync"] = ln.strip()
    ok = (len(evm_clean) >= args.min_frames
          and (max(evm_clean) if evm_clean else 0.0) <= args.evm_db
          and all(p.returncode == 0 for p in rxs + dms))
    rec = {
        "metric": "soak",
        "seconds": args.seconds,
        "geometry": f"{args.antennas}x{args.fft_size}x{args.frame_len}",
        "ring_dtype": args.ring_dtype,
        "rate": args.rate,
        "sync": "continuous" if args.continuous_sync else "one-shot",
        "consumer": (f"distributed-{args.distributed}"
                     if args.distributed else args.consumer),
        "sent_frames": nsent,
        "clean_frames": len(evm_clean),
        "dirty_frames": len(evm_dirty),
        "evm_clean_db": {
            "min": min(evm_clean) if evm_clean else None,
            "median": float(np.median(evm_clean)) if evm_clean else None,
            "max": max(evm_clean) if evm_clean else None,
        },
        "evm_dirty_max_db": max(evm_dirty) if evm_dirty else None,
        "threshold_db": args.evm_db,
        # The first nonzero exit code: max() would hide a child killed by
        # a signal (negative returncode) behind a sibling's 0.
        "rx_rc": _first_failure(p.returncode for p in rxs),
        "demod_rc": _first_failure(p.returncode for p in dms),
        "frames_target": args.frames or None,
        **overruns,
        "pass": ok,
    }
    print(json.dumps(rec))
    if not ok:
        print(f"rx stderr tail: {(rx_err or '')[-2000:]}", file=sys.stderr)
        print(f"demod stderr tail: {(dm_err or '')[-2000:]}", file=sys.stderr)
    if not args.keep and ok and args.dir is None:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
