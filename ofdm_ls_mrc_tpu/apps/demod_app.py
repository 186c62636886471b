"""Demodulator process: ring slave -> jitted LS+MRC -> Output file.

The equivalent of the reference's ``cpu``/``gpu`` entry mains
(cpuLS_main.cpp:57-106, gpuLS_main.cu:66-145): attach to the symbol ring as
slave, run ``num_times x (channel-estimate + demod)`` over frames, append
demodulated symbols to the output file, and print/store the phase-timing
report.

Run:  python -m ofdm_ls_mrc_tpu.apps.demod_app --antennas 16 --fft-size 1024 \\
          --cp-size 72 --frame-len 101 --num-frames 4
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shm-uid", default="/ofdm_ring",
                    help="shared-memory ring name (reference shmemID '/blah')")
    ap.add_argument("--antennas", type=int, default=16, help="numOfRows")
    ap.add_argument("--fft-size", type=int, default=1024, help="dimension")
    ap.add_argument("--cp-size", type=int, default=0, help="cyclic prefix length")
    ap.add_argument("--frame-len", type=int, default=101,
                    help="symbols per frame incl. pilot (lenOfBuffer)")
    ap.add_argument("--pilots", default="Pilots.dat",
                    help="pilot file (complex64, fftshift-ed on load)")
    ap.add_argument("--output", default="Output_gpu.dat",
                    help="demodulated output (raw complex64 rows)")
    ap.add_argument("--num-frames", type=int, default=1,
                    help="frames to process (numTimes); 0 = run until the "
                         "ring shuts down or SIGINT (live mode)")
    ap.add_argument("--fft-impl", default=None,
                    choices=[None, "xla", "matmul", "four_step"],
                    help="FFT implementation (default: jnp.fft, i.e. cuFFT "
                         "on the GPU)")
    ap.add_argument("--pipeline", default=None,
                    choices=["composed", "fast"],
                    help="demod body (models/body.py): composed = jnp.fft + "
                         "XLA-fused LS/MRC (default); fast = DFT-as-GEMM "
                         "permuted-order path")
    ap.add_argument("--batch-frames", type=int, default=1,
                    help="demodulate N whole frames per device dispatch via "
                         "the jitted capture scan (UplinkReceiver."
                         "demod_capture) -- amortizes per-frame dispatch "
                         "latency; disables the per-slot "
                         "timing table (decode granularity is the batch)")
    ap.add_argument("--per-symbol", action="store_true",
                    help="per-symbol streaming mode: ring -> "
                         "StreamingDemodulator -> output row per symbol, with "
                         "faithful per-slot read/chanest/decode timing rows "
                         "(the reference's main runtime loop, "
                         "cpuLS_main.cpp:80-93, gpuLS.cu:410-473)")
    ap.add_argument("--link-quality", default=None, metavar="SCHEME",
                    help="report decision-directed EVM per emitted block "
                         "and overall (no ground truth needed: error vector "
                         "to the NEAREST constellation point of SCHEME, "
                         "e.g. qpsk/16qam/64qam) -- the live link-quality "
                         "metric an operator watches; trustworthy while the "
                         "symbol error rate is low (errors snap to wrong "
                         "points and flatter the number otherwise). "
                         "Whole-frame/batch modes only")
    ap.add_argument("--catch-up", action="store_true",
                    help="real-time mode: skip stale queued frames instead of "
                         "draining backlog (readLastSymbol semantics); in "
                         "--per-symbol mode data symbols are read with "
                         "readLastSymbol semantics like the reference GPU "
                         "loop (gpuLS.cu:419-424)")
    ap.add_argument("--ring-dtype", default="complex64",
                    choices=["complex64", "sc16"],
                    help="shm element format (must match the RX master)")
    ap.add_argument("--mesh", default=None, metavar="ANTxTIME",
                    help="demodulate on the SHARDED receiver over an "
                         "(ant, time) device mesh (antenna-sharded MRC with "
                         "one fused psum; parallel/sharded.py), e.g. 1x1 on "
                         "one card or 4x1 on four")
    ap.add_argument("--sc16-native", action="store_true",
                    help="feed the device planar INT16 straight from an sc16 "
                         "ring (half the host and H2D bytes; the jitted "
                         "body widens to float32 on the device).  Requires "
                         "--ring-dtype sc16; disables the per-slot timer")
    ap.add_argument("--drop-dirty", action="store_true",
                    help="exclude BEST-EFFORT (possibly misaligned) frames "
                         "delivered under sustained writer overrun from the "
                         "output file entirely (they are still recorded in "
                         "the frame index as dropped-dirty)")
    ap.add_argument("--frame-index", default=None, metavar="FILE",
                    help="sideband per-frame provenance index written next "
                         "to the output (default <output>.index; 'none' "
                         "disables).  One line per delivered frame: "
                         "'<seq> <clean|dirty|dropped-dirty> <row_start> "
                         "<row_end> <writer_seq> [<dd_evm_db>]' -- row range "
                         "into the output file (-1 -1 when not emitted), the "
                         "writer-stream frame ordinal (-1 when unknown), "
                         "and, under --link-quality, the frame's "
                         "decision-directed EVM as a sixth column; "
                         "which maps each block back to the transmitted "
                         "frame across catch-up skips and overrun drops.  "
                         "Lets downstream consumers "
                         "drop frames that were delivered best-effort during "
                         "overrun (readLastSymbol-style deliberate loss, "
                         "reference ShMemSymBuff.hpp:300-331, made "
                         "observable)")
    ap.add_argument("--timeout", type=float, default=30.0,
                    help="ring spin-wait timeout seconds")
    ap.add_argument("--store-times", default=None,
                    help="write binary 5-word timing dump (time_*.dat layout)")
    ap.add_argument("--save-state", default=None, metavar="FILE",
                    help="per-symbol mode: checkpoint the channel estimate "
                         "after every frame (io/state layout, portable "
                         "across pipelines)")
    ap.add_argument("--resume", default=None, metavar="FILE",
                    help="per-symbol mode: restore a checkpointed channel "
                         "estimate before the first frame (restart-resume)")
    ap.add_argument("--dump-symbols", default=None, metavar="FILE",
                    help="debug tap: append every symbol read from the ring "
                         "as raw complex64 (the reference's testEnabled "
                         "Sym_copy_sh_mem.dat dump inside the read path, "
                         "ShMemSymBuff.hpp:355-362)")
    ap.add_argument("--no-timer", action="store_true")
    ap.add_argument("--distributed", default=None, metavar="HOST:PORT",
                    help="multi-process antenna-sharded run (jax.distributed "
                         "coordinator address): each process reads ITS "
                         "antennas' symbols from its own local ring "
                         "(--antennas is the GLOBAL count) and the MRC psum "
                         "is the only cross-process traffic")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="--distributed: total process count")
    ap.add_argument("--process-id", type=int, default=None,
                    help="--distributed: this process's id (0-based; "
                         "process 0 writes the output file)")
    ap.add_argument("--local-devices", default=None, metavar="IDS",
                    help="--distributed: comma list of the local device ids "
                         "this process opens (e.g. '2' for the third card of "
                         "a host running one process per card); default: "
                         "every local device")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..utils import compile_cache
    print(f"compilation cache: {compile_cache.enable()}", file=sys.stderr)

    from ..config import FrameConfig
    from ..golden.io import append_output, load_pilot
    from ..io.feed import RingFeed
    from ..io.ring import SymbolRing
    from ..models import UplinkReceiver
    from ..utils.timing import PhaseTimer

    # The ring drops the CP during copy-out, so the device pipeline sees
    # CP-free symbols (cyclic_prefix=0 here; --cp-size shapes the ring).
    cfg = FrameConfig(num_antennas=args.antennas, fft_size=args.fft_size,
                      cyclic_prefix=0, frame_len=args.frame_len)
    ring_cols = args.fft_size + args.cp_size

    pilot = load_pilot(args.pilots, cfg.num_subcarriers)

    if args.link_quality is not None:
        from ..sim.channel import CONSTELLATIONS
        if args.link_quality not in CONSTELLATIONS:
            print(f"--link-quality {args.link_quality!r}: unknown scheme "
                  f"(choices: {', '.join(sorted(CONSTELLATIONS))})",
                  file=sys.stderr)
            return 2

    if args.distributed:
        return _run_distributed(args, cfg, pilot)

    if args.mesh:
        if args.per_symbol and args.mesh.lower().split("x")[-1] != "1":
            print("--mesh with --per-symbol streams over the ant axis only "
                  "(time shards need whole frames); use ANTx1",
                  file=sys.stderr)
            return 2
        try:
            n_ant, n_time = (int(v) for v in args.mesh.lower().split("x"))
            if n_ant < 1 or n_time < 1:
                raise ValueError
        except ValueError:
            print(f"--mesh {args.mesh!r}: expected ANTxTIME, e.g. 1x1 or 4x2",
                  file=sys.stderr)
            return 2
        # Divisibility up front: failing inside shard_map during warm-up
        # (producer already writing) prints an opaque XLA shape error.
        if args.antennas % n_ant:
            print(f"--mesh {args.mesh}: {args.antennas} antennas not "
                  f"divisible by {n_ant} ant shards", file=sys.stderr)
            return 2
        if (args.frame_len - 1) % n_time:
            print(f"--mesh {args.mesh}: {args.frame_len - 1} data symbols "
                  f"not divisible by {n_time} time shards", file=sys.stderr)
            return 2
    else:
        n_ant = n_time = 0

    if args.sc16_native and args.ring_dtype != "sc16":
        print("--sc16-native requires --ring-dtype sc16", file=sys.stderr)
        return 2

    if args.batch_frames > 1 and args.per_symbol:
        print("note: --batch-frames has no effect in --per-symbol mode",
              file=sys.stderr)
    if args.per_symbol and args.drop_dirty:
        # --drop-dirty is RingFeed machinery (best-effort frame exclusion
        # under sustained overrun); the per-symbol loop's deliberate-loss
        # mode is --catch-up, whose skips the index records as caught-up.
        print("--drop-dirty is a whole-frame provenance mode "
              "(not --per-symbol)", file=sys.stderr)
        return 2
    continuous = args.num_frames <= 0
    timer = None if (args.no_timer or continuous
                     or (args.sc16_native and not args.per_symbol)
                     or (args.batch_frames > 1 and not args.per_symbol)
                     ) else PhaseTimer(
        num_slots=args.frame_len, num_times=args.num_frames)

    # One mesh for either consumer (--per-symbol runs ANTx1, gated above).
    mesh = None
    if args.mesh:
        import jax as _jax

        from ..parallel import make_mesh
        devs = _jax.devices()
        need = n_ant * n_time
        if len(devs) < need:
            print(f"--mesh {args.mesh} needs {need} devices, "
                  f"have {len(devs)}", file=sys.stderr)
            return 2
        mesh = make_mesh(n_ant, n_time, devices=devs[:need])

    ring = SymbolRing(args.shm_uid, args.antennas, ring_cols, args.frame_len,
                      master=False, timeout=args.timeout, dtype=args.ring_dtype)

    if args.per_symbol:
        return _run_per_symbol(args, cfg, pilot, ring, timer, continuous,
                               mesh=mesh)

    if mesh is not None:
        from ..parallel import ShardedUplinkReceiver
        rx = ShardedUplinkReceiver(cfg, pilot, mesh,
                                   fft_impl=args.fft_impl,
                                   pipeline=args.pipeline)
    else:
        rx = UplinkReceiver(cfg, pilot, fft_impl=args.fft_impl,
                            pipeline=args.pipeline)
    put_fn = None
    if mesh is not None:
        # Mesh-sharded placement: antennas land on their shards at
        # device_put time so the jitted shard_map needn't reshard every
        # frame.
        import jax as _jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..ops.cplx import CArray as _CArray
        from ..parallel.mesh import ANT_AXIS
        sh = NamedSharding(mesh, P(None, ANT_AXIS, None))

        def put_fn(re_h, im_h):
            return _CArray(_jax.device_put(re_h, sh),
                           _jax.device_put(im_h, sh))

    feed = _make_feed(ring, cfg, args.cp_size, timer, catch_up=args.catch_up,
                      int16=args.sc16_native, put_fn=put_fn)

    import jax

    # Warm at the EXACT dtype and placement the feed will deliver: int16
    # planes in sc16-native mode specialize a separate jit entry, and the
    # sharded program specializes on its input shardings.
    feed_dtype = np.int16 if args.sc16_native else np.float32
    shape = (cfg.frame_len, cfg.num_antennas, cfg.fft_size)
    if args.sc16_native or args.mesh:
        from ..ops.cplx import CArray
        zr, zi = np.zeros(shape, feed_dtype), np.zeros(shape, feed_dtype)
        z = put_fn(zr, zi) if put_fn is not None else CArray(zr, zi)
        jax.block_until_ready(rx.demod_frame(z).re)
    else:
        rx.warmup()
    if args.batch_frames > 1:
        # Warm the capture scan at the exact batched shape so the first live
        # batch doesn't stall the ring on a compile.
        import jax.numpy as jnp

        from ..ops.cplx import CArray
        zr, zi = np.zeros(shape, feed_dtype), np.zeros(shape, feed_dtype)
        # Mirror flush_batch EXACTLY: per-frame put_fn placement, then the
        # same jnp.stack -- warming a plain host batch under --mesh would
        # specialize the scan on a different input sharding and the first
        # live batch would recompile mid-stream.
        zf = [put_fn(zr, zi) if put_fn is not None else CArray(zr, zi)
              for _ in range(args.batch_frames)]
        z = CArray(jnp.stack([f.re for f in zf]),
                   jnp.stack([f.im for f in zf]))
        jax.block_until_ready(rx.demod_capture(z).re)

    n = 0
    wrote_any = False
    batch = []          # [(frame, dirty)] pending in --batch-frames mode
    dropped_dirty = 0
    rows_per_frame = cfg.num_data_symbols
    index_path = (None if args.frame_index == "none"
                  else (args.frame_index or args.output + ".index"))
    index_f = open(index_path, "w") if index_path else None
    emitted_rows = 0
    seq = 0             # delivered-frame ordinal (incl. dropped-dirty)

    def index_record(status, nrows, wseq=-1, rows=None):
        """One provenance line per delivered frame: delivered seq, status,
        the emitted row range in the output file (-1 -1 when not emitted),
        and the writer-stream frame ordinal (maps each block back to WHICH
        transmitted frame it came from across catch-up skips and overrun
        drops; -1 when unknown).  Under --link-quality an optional sixth
        column carries the frame's decision-directed EVM in dB, so
        operators can locate WHICH delivered frame degraded (existing
        consumers split by whitespace and ignore trailing columns)."""
        nonlocal emitted_rows, seq
        evm = (lq.update(rows) if (lq is not None and rows is not None)
               else None)
        if index_f is not None:
            lo, hi = ((emitted_rows, emitted_rows + nrows) if nrows
                      else (-1, -1))
            tail = "" if evm is None else f" {evm:.2f}"
            index_f.write(f"{seq} {status} {lo} {hi} {wseq}{tail}\n")
            index_f.flush()
        emitted_rows += nrows
        seq += 1

    lq = _LinkQuality(args.link_quality) if args.link_quality else None

    def emit(arr):
        nonlocal wrote_any
        append_output(args.output, arr, truncate=not wrote_any)
        wrote_any = True

    def demod_batch(frames):
        import jax.numpy as jnp

        from ..ops.cplx import CArray
        stacked = CArray(jnp.stack([f.re for f in frames]),
                         jnp.stack([f.im for f in frames]))
        out = rx.demod_capture(stacked)          # [K, S-1, F-1]
        o = out.to_numpy()
        return o.reshape(-1, o.shape[-1])

    dump_f = open(args.dump_symbols, "wb") if args.dump_symbols else None

    def dump_frame(fr):
        _dump_planes(dump_f, np.asarray(fr.re), np.asarray(fr.im))

    def flush_batch():
        """Emit a full batch with one capture-scan dispatch + index rows.
        Dropped-dirty tombstones (frame is None) ride the queue so index
        lines come out in DELIVERY order -- recording a drop eagerly would
        give it a lower seq than clean frames delivered before it."""
        nonlocal batch
        rows = demod_batch([f for f, _, _ in batch if f is not None])
        emit(rows)
        j = 0   # emitted-frame ordinal within this batch
        for fr, was_dirty, wseq in batch:
            if fr is None:
                index_record("dropped-dirty", 0, wseq)
            else:
                index_record("dirty" if was_dirty else "clean",
                             rows_per_frame, wseq,
                             rows=rows[j * rows_per_frame:
                                       (j + 1) * rows_per_frame])
                j += 1
        batch = []

    try:
        for frame in feed.frames(max_frames=None if continuous
                                 else args.num_frames):
            dirty = feed.last_frame_dirty
            wseq = feed.last_frame_writer_seq
            if dump_f is not None:
                dump_frame(frame)
            if dirty and args.drop_dirty:
                dropped_dirty += 1
                if args.batch_frames > 1 and batch:
                    # Keep index lines in delivery order: queue a tombstone
                    # behind the frames already pending in this batch.
                    batch.append((None, True, wseq))
                else:
                    index_record("dropped-dirty", 0, wseq)
                continue
            if args.batch_frames > 1:
                # Capture mode: one jitted scan dispatch per N frames.
                batch.append((frame, dirty, wseq))
                n += 1
                if sum(1 for f, _, _ in batch
                       if f is not None) == args.batch_frames:
                    flush_batch()
                continue
            if timer:
                # Whole-frame pipeline: channel estimation is fused into the
                # decode.  Frame 0 lands in slot 0 -- EXCLUDED from the
                # table's stats, like the reference's &decode[1] averaging --
                # so first-dispatch overhead doesn't pollute the steady-state
                # numbers; later frames cycle slots 1..L-1.  A single-frame
                # run has no steady state, so its one frame goes to slot 1.
                # FFT and Drop rows are structurally zero here: the FFT is
                # fused into the decode program and the CP drop happens
                # inside the ring's native copy-out (counted in Read).
                if args.num_frames == 1:
                    slot = 1
                elif n == 0:
                    slot = 0
                else:
                    slot = 1 + ((n - 1) % max(args.frame_len - 1, 1))
                with timer.phase("decode", slot):
                    out = rx.demod_frame(frame)
                    jax.block_until_ready(out.re)
            else:
                out = rx.demod_frame(frame)
            o = out.to_numpy()
            emit(o)
            index_record("dirty" if dirty else "clean", rows_per_frame, wseq,
                         rows=o)
            n += 1
    except KeyboardInterrupt:
        print(f"SIGINT: stopping after {n} frame(s)")
    # Flush a short trailing batch per-frame (a different K would recompile
    # the capture scan).
    for fr, was_dirty, wseq in batch:
        if fr is None:
            index_record("dropped-dirty", 0, wseq)
            continue
        o = rx.demod_frame(fr).to_numpy()
        emit(o)
        index_record("dirty" if was_dirty else "clean", rows_per_frame, wseq,
                     rows=o)
    if dump_f is not None:
        dump_f.close()
    if index_f is not None:
        index_f.close()
    print(f"demodulated {n} frame(s) -> {args.output}")
    if lq is not None and lq.blocks:
        print(f"link quality ({lq.scheme} decision-directed EVM): "
              f"{lq.overall_db():.1f} dB overall, worst block "
              f"{lq.worst_db:.1f} dB over {lq.blocks} block(s)")
    if feed.drop_events:
        print(f"writer overruns: {feed.drop_events} event(s), "
              f"{feed.resynced_frames} boundary resync(s), "
              f"{feed.dirty_frames} BEST-EFFORT (possibly misaligned) "
              f"frame(s) delivered under sustained pressure"
              + (f", {dropped_dirty} excluded from the output "
                 f"(--drop-dirty)" if dropped_dirty else ""),
              file=sys.stderr)

    if timer:
        timer.print_times()
        if args.store_times:
            timer.store_times(args.store_times)
    feed.stop()   # join the reader thread before unmapping the segment
    ring.close()
    return 0


def _run_distributed(args, cfg, pilot) -> int:
    """Antenna-across-hosts demod: N processes, each reading ITS antennas'
    symbols (all frame slots) from its OWN local ring -- BASELINE config 5's
    64-antenna split, the app-level twin of tests/_mh_worker.py leg 3.  The
    fused MRC psum ((2*S_data+1)*F fp32 words/frame) is the only
    cross-process frame traffic (parallel/multihost.py).

    Each host runs the SAME RingFeed machinery as the single-host consumer
    (reader-thread overlap, overrun resync, dirty provenance, catch-up,
    sc16-native int16 shards, continuous --num-frames 0), plus a per-frame
    LOCKSTEP agreement: hosts exchange (writer_seq, dirty, end) in a tiny
    allgather and laggards skip forward until every host holds the SAME
    writer frame -- without it, independent per-host drops would silently
    MRC-combine different transmitted frames.  Rank 0 writes the merged
    provenance index (dirty if ANY host's shard was best-effort)."""
    import jax

    from ..golden.io import append_output
    from ..io.ring import SymbolRing
    from ..parallel import ShardedUplinkReceiver
    from ..parallel.multihost import initialize, make_multihost_mesh

    if args.per_symbol or args.mesh:
        print("--distributed is a whole-frame mode (not --per-symbol/"
              "--mesh)", file=sys.stderr)
        return 2
    if args.sc16_native and args.ring_dtype != "sc16":
        # main() routes here before its own sc16 validation block.
        print("--sc16-native requires --ring-dtype sc16", file=sys.stderr)
        return 2
    if args.drop_dirty:
        print("--drop-dirty is not supported under --distributed "
              "(the merged index records dirty frames; excluding them "
              "would desync rank-0 row accounting)", file=sys.stderr)
        return 2
    continuous = args.num_frames <= 0
    local_ids = None
    if args.local_devices:
        try:
            local_ids = [int(v) for v in args.local_devices.split(",")]
        except ValueError:
            print(f"--local-devices {args.local_devices!r}: expected a comma "
                  "list of integers", file=sys.stderr)
            return 2
    initialize(args.distributed, args.num_processes, args.process_id,
               local_device_ids=local_ids)
    from jax.experimental import multihost_utils
    nproc = jax.process_count()
    pid = jax.process_index()
    if cfg.num_antennas % nproc:
        print(f"{cfg.num_antennas} global antennas not divisible by {nproc} "
              f"processes", file=sys.stderr)
        return 2
    a_local = cfg.num_antennas // nproc
    # Antennas shard over every device when the global count divides evenly,
    # else one shard per process; time stays unsharded so the output is
    # replicated.  make_multihost_mesh takes devices process-major, so each
    # process's local antenna block lands on its own devices.
    ndev = jax.device_count()
    if cfg.num_antennas % ndev == 0:
        mesh = make_multihost_mesh(ant_shards=ndev, time_shards=1)
    else:
        # One antenna shard PER PROCESS: the mesh must span every process
        # (each contributes its local block), so take each process's first
        # device -- jax.devices()[:nproc] can land entirely on process 0
        # when processes carry several virtual devices.
        from jax.sharding import Mesh as _Mesh

        from ..parallel.mesh import ANT_AXIS as _A, TIME_AXIS as _T
        by_proc = {}
        for d in jax.devices():
            by_proc.setdefault(d.process_index, d)
        mesh = _Mesh(np.array([by_proc[i] for i in range(nproc)]
                              ).reshape(nproc, 1), (_A, _T))
    rx = ShardedUplinkReceiver(cfg, pilot, mesh, fft_impl=args.fft_impl,
                               pipeline=args.pipeline)
    # Which process holds each antenna shard, in shard order: process i
    # must hold shard(s) of block i, the antennas its own ring carries.
    owners = [d.process_index for d in mesh.devices[:, 0]]
    print(f"[proc {pid}] antenna shards on processes {owners}",
          file=sys.stderr)

    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops.cplx import CArray
    from ..parallel.mesh import ANT_AXIS

    gsh = NamedSharding(mesh, P(None, ANT_AXIS, None))

    dump_f = None       # opened after the warm-up, which must not be dumped

    def put_fn(re_h, im_h):
        """Host-local planar block -> global antenna-sharded frame (no
        cross-host data movement; int16 planes stay int16).  The debug tap
        dumps this process's antennas of every frame read."""
        if dump_f is not None:
            _dump_planes(dump_f, re_h, im_h)
        gre = jax.make_array_from_process_local_data(gsh, re_h)
        gim = jax.make_array_from_process_local_data(gsh, im_h)
        return CArray(gre, gim)

    # Slice pilot/data INSIDE one jit: eager indexing of a multi-process
    # global array is not addressable host-side.
    demod_split = rx._demod

    @jax.jit
    def demod(c):
        return demod_split(c[0], c[1:], rx.x_full)

    def to_host(out):
        # time_shards == 1 => the output is replicated on every device.
        return (np.asarray(out.re.addressable_shards[0].data)
                + 1j * np.asarray(out.im.addressable_shards[0].data)
                ).astype(np.complex64)

    # Warm at the live shape + dtype BEFORE touching the ring, so the first
    # frame doesn't stall the producer on a compile.
    feed_dtype = np.int16 if args.sc16_native else np.float32
    zshape = (cfg.frame_len, a_local, cfg.fft_size)
    jax.block_until_ready(
        demod(put_fn(np.zeros(zshape, feed_dtype),
                     np.zeros(zshape, feed_dtype))).re)

    ring = SymbolRing(args.shm_uid, a_local, args.fft_size + args.cp_size,
                      cfg.frame_len, master=False, timeout=args.timeout,
                      dtype=args.ring_dtype)
    if args.dump_symbols:
        dump_f = open(args.dump_symbols, "wb")
    # The per-host feed sees LOCAL geometry (this host's antenna shard).
    from ..config import FrameConfig as _FC
    cfg_local = _FC(num_antennas=a_local, fft_size=cfg.fft_size,
                    cyclic_prefix=0, frame_len=cfg.frame_len)
    feed = _make_feed(ring, cfg_local, args.cp_size, None,
                      catch_up=args.catch_up,
                      int16=args.sc16_native, put_fn=put_fn)
    gen = feed.frames()

    def next_frame():
        try:
            fr = next(gen)
            return fr, int(feed.last_frame_writer_seq), feed.last_frame_dirty
        except StopIteration:
            return None, -1, False

    lq = (_LinkQuality(args.link_quality)
          if (args.link_quality and pid == 0) else None)
    index_path = (None if args.frame_index == "none"
                  else (args.frame_index or args.output + ".index"))
    index_f = (open(index_path, "w")
               if (index_path and pid == 0) else None)
    rows = 0
    k = 0
    skipped = 0
    try:
        fr, wseq, dirty = next_frame()
        while continuous or k < args.num_frames:
            # Lockstep agreement: everyone contributes (wseq|-2, dirty);
            # laggards advance to the max writer seq; any END (-2) ends
            # the run everywhere (all hosts make the SAME number of
            # collective calls per round -- no deadlock).
            while True:
                g = multihost_utils.process_allgather(
                    np.array([wseq if fr is not None else -2,
                              1 if dirty else 0], np.int64))
                g = g.reshape(-1, 2)
                if (g[:, 0] == -2).any():
                    fr = None
                    break
                tgt = int(g[:, 0].max())
                if (g[:, 0] == tgt).all():
                    dirty = bool(g[:, 1].any())
                    break
                while fr is not None and wseq < tgt:
                    fr, wseq, dirty = next_frame()
                    skipped += 1
            if fr is None:
                break
            o = to_host(demod(fr))
            if pid == 0:
                append_output(args.output, o, truncate=(k == 0))
                evm = lq.update(o) if lq is not None else None
                if index_f is not None:
                    status = "dirty" if dirty else "clean"
                    tail = "" if evm is None else f" {evm:.2f}"
                    index_f.write(f"{k} {status} {rows} "
                                  f"{rows + o.shape[0]} {wseq}{tail}\n")
                    index_f.flush()
            rows += o.shape[0]
            k += 1
            fr, wseq, dirty = next_frame()
    except KeyboardInterrupt:
        print(f"[proc {pid}] SIGINT: stopping after {k} frame(s)",
              file=sys.stderr)
    finally:
        feed.stop()
        ring.close()
        if index_f is not None:
            index_f.close()
        if dump_f is not None:
            dump_f.close()
    print(f"[proc {pid}] demodulated {rows} data symbols over {k} frame(s) "
          f"across {nproc} processes x {a_local} antennas "
          f"({rx.pipeline} pipeline"
          + (", sc16-native" if args.sc16_native else "")
          + (f", {skipped} frame(s) skipped in lockstep catch-up"
             if skipped else "") + ")",
          file=sys.stderr)
    if feed.drop_events:
        print(f"[proc {pid}] writer overruns: {feed.drop_events} event(s), "
              f"{feed.resynced_frames} boundary resync(s), "
              f"{feed.dirty_frames} best-effort frame(s)", file=sys.stderr)
    if lq is not None and lq.blocks:
        print(f"link quality ({lq.scheme} decision-directed EVM): "
              f"{lq.overall_db():.1f} dB overall, worst block "
              f"{lq.worst_db:.1f} dB over {lq.blocks} block(s)")
    return 0


class _LinkQuality:
    """Decision-directed EVM over emitted output blocks: the error vector to
    the NEAREST constellation point, so live link quality needs no ground
    truth (the reference has no runtime quality metric at all; its
    verification is offline file diffing, SURVEY.md section 4).  Reliable
    while the symbol error rate is low -- hard-decision errors snap to the
    wrong point and understate the error power past roughly the scheme's
    working SER."""

    def __init__(self, scheme: str):
        from ..sim.channel import CONSTELLATIONS

        self.scheme = scheme
        self._const = CONSTELLATIONS[scheme]
        self._err_pow = 0.0
        self._ref_pow = 0.0
        self.blocks = 0
        self.worst_db = float("-inf")

    def update(self, rows: np.ndarray) -> float:
        """rows: [N, F-1] reference-layout output; returns this block's
        dd-EVM in dB and folds it into the running totals."""
        import math

        from ..sim.channel import demap_symbols

        # Nearest-point demap is invariant to column permutations, so the
        # reference layout's ifftshift needs no undoing here.
        ref = self._const[demap_symbols(rows, self.scheme)]
        err = float(np.sum(np.abs(rows - ref) ** 2))
        refp = float(np.sum(np.abs(ref) ** 2))
        self._err_pow += err
        self._ref_pow += refp
        self.blocks += 1
        block_db = 10.0 * math.log10(err / max(refp, 1e-30) + 1e-30)
        self.worst_db = max(self.worst_db, block_db)
        return block_db

    def overall_db(self) -> float:
        import math

        return 10.0 * math.log10(
            self._err_pow / max(self._ref_pow, 1e-30) + 1e-30)


def _run_per_symbol(args, cfg, pilot, ring, timer, continuous,
                    mesh=None) -> int:
    """Per-symbol streaming loop: the reference's main runtime shape
    (firstVector + per-symbol demodOneSymbol, cpuLS_main.cpp:80-93,
    gpuLS.cu:410-473) -- read a symbol from the ring, refresh the estimate on
    slot 0, demod and append an output row on slots 1..L-1, with per-slot
    read (here) / chanest / decode (inside StreamingDemodulator) timers.
    With ``mesh`` (an ANTx1 --mesh) the antenna-sharded streaming path runs
    instead: the estimate stays device-resident per shard and every symbol
    costs one 2*F-word psum (parallel/streaming.py)."""
    import jax

    from ..golden.io import append_output
    from ..io.ring import RingShutdown, RingTimeout
    from ..models.streaming import StreamingDemodulator
    from ..ops.cplx import CArray

    if mesh is not None:
        from ..parallel.streaming import ShardedStreamingDemodulator

        sd = ShardedStreamingDemodulator(cfg, pilot, mesh,
                                         fft_impl=args.fft_impl, timer=timer,
                                         pipeline=args.pipeline)
    else:
        if args.pipeline not in (None, "composed"):
            print(f"note: --per-symbol has no {args.pipeline!r} variant; "
                  f"using 'composed' (the reference per-symbol semantics)",
                  file=sys.stderr)
        sd = StreamingDemodulator(cfg, pilot, fft_impl=args.fft_impl,
                                  timer=timer)
    sd.warmup(int16=args.sc16_native)
    import os
    if args.resume and os.path.exists(args.resume):
        idx = sd.resume(args.resume)
        print(f"resumed channel estimate from {args.resume} (frame {idx})")

    cp = args.cp_size
    n_sym = 0
    frames_done = 0
    first_write = True
    dump_f = open(args.dump_symbols, "wb") if args.dump_symbols else None

    # Live observability for the low-latency loop: decision-directed EVM
    # over the emitted rows and a per-frame provenance line in the SAME
    # index format as the whole-frame consumer.
    # The writer-stream mapping rides the ring's consumed counter: the
    # pilot's symbol ordinal c identifies writer frame c // frame_len, and
    # a frame whose consumed span exceeds frame_len had catch-up skips
    # (readLastSymbol deliberate loss, ShMemSymBuff.hpp:300-331) and is
    # recorded as caught-up instead of clean.
    lq = _LinkQuality(args.link_quality) if args.link_quality else None
    index_path = (None if args.frame_index == "none"
                  else (args.frame_index or args.output + ".index"))
    index_f = open(index_path, "w") if index_path else None
    rows_per_frame = args.frame_len - 1
    cur_rows = []           # this frame's emitted rows (for lq + index)
    frame_start_c = None    # ring.consumed at this frame's pilot read
    emitted_rows = 0
    seq = 0

    def index_record(end_c):
        """Emit the completed frame's index line + fold its rows into lq."""
        nonlocal cur_rows, frame_start_c, emitted_rows, seq
        if not cur_rows:
            return
        rows = np.stack(cur_rows)
        evm = lq.update(rows) if lq is not None else None
        if index_f is not None:
            wseq = -1 if frame_start_c is None else frame_start_c // args.frame_len
            span = None if (frame_start_c is None or end_c is None) \
                else end_c - frame_start_c
            status = ("clean" if span == args.frame_len else "caught-up")
            lo = emitted_rows
            tail = "" if evm is None else f" {evm:.2f}"
            index_f.write(f"{seq} {status} {lo} {lo + len(cur_rows)} "
                          f"{wseq}{tail}\n")
            index_f.flush()
        emitted_rows += len(cur_rows)
        seq += 1
        cur_rows = []

    # One-deep streaming pipeline: the demod of symbol k is DISPATCHED
    # (push_symbol_async) and left in flight while the ring read of symbol
    # k+1 proceeds; only then is k's output waited for and appended.  This
    # is the reference's per-symbol copy/compute overlap
    # (ShMemSymBuff_cucomplex.hpp:356-393: dedicated streams per symbol,
    # waited one symbol later in gpuLS.cu:410-473).  Timing honesty: the
    # decode column records the WAIT, not the overlapped span -- exactly
    # what the reference's post-stream timer measured.
    pending = None          # (out, slot) of the in-flight symbol

    def flush_pending():
        nonlocal pending, first_write
        if pending is None:
            return
        out, pslot = pending
        pending = None
        if timer:
            import jax as _jax
            with timer.phase("decode", pslot):
                _jax.block_until_ready(out.re)
        o = out.to_numpy()
        append_output(args.output, o, truncate=first_write)
        first_write = False
        if lq is not None or index_f is not None:
            cur_rows.append(o)

    try:
        f = 0
        while continuous or f < args.num_frames:
            for slot in range(args.frame_len):
                # Data symbols honor readLastSymbol semantics under
                # --catch-up (the reference GPU loop, gpuLS.cu:419-424);
                # the pilot always reads in order to keep frame alignment.
                # sc16-native reads deliver planar INT16 straight off the
                # wire format (half the per-dispatch input copy; the jitted
                # bodies widen on device).
                if args.sc16_native:
                    read = (ring.read_last_planar_i16
                            if (args.catch_up and slot > 0)
                            else ring.read_next_planar_i16)
                else:
                    read = (ring.read_last_planar
                            if (args.catch_up and slot > 0)
                            else ring.read_next_planar)
                c_now = ring.consumed if slot == 0 else None
                if timer:
                    with timer.phase("read", slot):
                        re, im = read(cp=cp)
                else:
                    re, im = read(cp=cp)
                flush_pending()      # symbol k-1's wait, AFTER k's read
                if slot == 0:
                    # Previous frame fully flushed: emit its index line
                    # (its consumed span ends where this pilot begins).
                    index_record(c_now)
                    frame_start_c = c_now
                if dump_f is not None:
                    _dump_planes(dump_f, re, im)
                sym = CArray(re, im)
                if slot == 0:
                    sd.push_pilot(sym, slot=slot)
                else:
                    pending = (sd.push_symbol_async(sym, slot=slot), slot)
                n_sym += 1
            frames_done += 1
            if args.save_state:
                flush_pending()      # frame fully materialized before ckpt
                sd.save_state(args.save_state, frame_index=frames_done)
            f += 1
    except KeyboardInterrupt:
        print(f"SIGINT: stopping after {frames_done} frame(s), {n_sym} symbols")
    except (RingShutdown, RingTimeout) as e:
        print(f"ring ended ({type(e).__name__}) after {frames_done} frame(s), "
              f"{n_sym} symbols")
    flush_pending()
    index_record(ring.consumed)
    if index_f is not None:
        index_f.close()
    if dump_f is not None:
        dump_f.close()
    print(f"demodulated {frames_done} frame(s) per-symbol -> {args.output}")
    if lq is not None and lq.blocks:
        print(f"link quality ({lq.scheme} decision-directed EVM): "
              f"{lq.overall_db():.1f} dB overall, worst block "
              f"{lq.worst_db:.1f} dB over {lq.blocks} block(s)")
    if timer:
        timer.print_times()
        if args.store_times:
            timer.store_times(args.store_times)
    ring.close()
    return 0


def _dump_planes(fh, re: np.ndarray, im: np.ndarray) -> None:
    """Append planar symbols to the debug tap as raw complex64 (sc16 planes
    at full scale, as the device body widens them)."""
    if re.dtype != np.float32:
        from ..golden.io import SC16_FULL_SCALE
        re = re.astype(np.float32) / SC16_FULL_SCALE
        im = im.astype(np.float32) / SC16_FULL_SCALE
    (re + 1j * im).astype(np.complex64).tofile(fh)


def _make_feed(ring, cfg, cp_size, timer, catch_up=False, int16=False,
               put_fn=None):
    """RingFeed wired for a CP-carrying ring feeding a CP-free pipeline."""
    from ..io.feed import RingFeed

    class _CpRingView:
        """Presents the ring with CP-dropping reads as CP-free geometry."""

        def __init__(self, ring, cp):
            self._ring = ring
            self._cp = cp
            self.rows = ring.rows
            self.cols = ring.cols - cp

        def read_next_planar(self, cp=0):
            return self._ring.read_next_planar(cp=self._cp)

        def read_frame_planar(self, n, cp=0, out_re=None, out_im=None):
            return self._ring.read_frame_planar(n, cp=self._cp,
                                                out_re=out_re, out_im=out_im)

        def read_frame_planar_i16(self, n, cp=0, out_re=None, out_im=None):
            return self._ring.read_frame_planar_i16(n, cp=self._cp,
                                                    out_re=out_re,
                                                    out_im=out_im)

        @property
        def available(self):
            return self._ring.available

        @property
        def dropped(self):
            return self._ring.dropped

        @property
        def consumed(self):
            return self._ring.consumed

        @property
        def dtype(self):
            return self._ring.dtype

        def skip(self, n):
            return self._ring.skip(n)

        def shutdown(self):
            self._ring.shutdown()

    return RingFeed(_CpRingView(ring, cp_size), cfg, timer=timer,
                    catch_up=catch_up, int16=int16, put_fn=put_fn)


if __name__ == "__main__":
    sys.exit(main())
