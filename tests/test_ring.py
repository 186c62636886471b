"""Native shm ring: protocol semantics + concurrency tests.

Covers the reference ring protocol (ShMemSymBuff.hpp:193-484): empty-start
sentinel, with/without-wait writes, CP-drop on read, wrap-around, shutdown
handshake -- plus what the reference never tests: timeouts instead of
infinite spins, overrun accounting, and a threaded producer/consumer soak.
"""

import os
import threading
import uuid

import numpy as np
import pytest

from ofdm_ls_mrc_tpu.io.ring import (
    RingError,
    RingShutdown,
    RingTimeout,
    SymbolRing,
)

ROWS, COLS, CP, LEN = 4, 72, 8, 5


def _uid():
    return f"/ofdm_test_{uuid.uuid4().hex[:12]}"


def _sym(rng, scale=1.0):
    return (scale * (rng.standard_normal((ROWS, COLS))
                     + 1j * rng.standard_normal((ROWS, COLS)))).astype(np.complex64)


@pytest.fixture
def pair():
    uid = _uid()
    master = SymbolRing(uid, ROWS, COLS, LEN, master=True, timeout=5.0)
    slave = SymbolRing(uid, ROWS, COLS, LEN, master=False, timeout=5.0)
    yield master, slave
    slave.close()
    master.close()


class TestProtocol:
    def test_roundtrip(self, pair, rng):
        w, r = pair
        sym = _sym(rng)
        w.write(sym)
        got = r.read_next(cp=0)
        np.testing.assert_array_equal(got, sym)

    def test_cp_drop_on_read(self, pair, rng):
        w, r = pair
        sym = _sym(rng)
        w.write(sym)
        got = r.read_next(cp=CP)
        np.testing.assert_array_equal(got, sym[:, CP:])

    def test_planar_read_matches(self, pair, rng):
        w, r = pair
        sym = _sym(rng)
        w.write(sym)
        re, im = r.read_next_planar(cp=CP)
        np.testing.assert_array_equal(re, sym[:, CP:].real)
        np.testing.assert_array_equal(im, sym[:, CP:].imag)

    def test_fifo_order_with_wraparound(self, pair, rng):
        w, r = pair
        syms = [_sym(rng) for _ in range(3 * LEN)]
        out = []

        def produce():
            for s in syms:
                w.write(s, wait=True)

        t = threading.Thread(target=produce)
        t.start()
        for i in range(len(syms)):
            if i == len(syms) - 1:
                out.append(r.read_last(cp=0))
            else:
                out.append(r.read_next(cp=0))
        t.join()
        for got, want in zip(out, syms):
            np.testing.assert_array_equal(got, want)

    def test_read_empty_times_out(self, pair):
        _, r = pair
        with pytest.raises(RingTimeout):
            r.read_next(cp=0, timeout=0.1)

    def test_slave_times_out_without_master(self):
        with pytest.raises(Exception, match="ring_open"):
            SymbolRing(_uid(), ROWS, COLS, LEN, master=False, timeout=0.2)

    def test_shutdown_unblocks_reader(self, pair):
        w, r = pair
        exc = []

        def read():
            try:
                r.read_next(cp=0, timeout=10.0)
            except RingShutdown as e:
                exc.append(e)

        t = threading.Thread(target=read)
        t.start()
        w.shutdown()
        t.join(timeout=5.0)
        assert not t.is_alive()
        assert exc, "reader should observe the shutdown sentinel"

    def test_nowait_writer_counts_overruns(self, pair, rng):
        w, _ = pair
        for _ in range(3 * LEN):
            w.write(_sym(rng), wait=False)
        assert w.dropped > 0

    def test_geometry_mismatch_rejected(self):
        uid = _uid()
        m = SymbolRing(uid, ROWS, COLS, LEN, master=True)
        try:
            with pytest.raises(Exception, match="ring_open"):
                SymbolRing(uid, ROWS + 1, COLS, LEN, master=False, timeout=0.3)
        finally:
            m.close()

    def test_bad_symbol_shape_rejected(self, pair, rng):
        w, _ = pair
        with pytest.raises(ValueError, match="shape"):
            w.write(np.zeros((ROWS, COLS + 1), np.complex64))


class TestConcurrency:
    def test_threaded_soak(self, rng):
        """Producer and consumer hammer the ring across many wraps; every
        symbol arrives intact and in order (the reference's unsynchronized
        int cursors cannot guarantee this)."""
        uid = _uid()
        n = 40 * LEN
        payloads = np.arange(n, dtype=np.float32)
        w = SymbolRing(uid, ROWS, COLS, LEN, master=True, timeout=10.0)
        r = SymbolRing(uid, ROWS, COLS, LEN, master=False, timeout=10.0)
        got = []

        def produce():
            for k in range(n):
                sym = np.full((ROWS, COLS), payloads[k] + 1j * payloads[k],
                              np.complex64)
                w.write(sym, wait=True)

        def consume():
            for k in range(n):
                if k == n - 1:
                    s = r.read_last(cp=0)
                else:
                    s = r.read_next(cp=0)
                got.append(s[0, 0].real)

        tp = threading.Thread(target=produce)
        tc = threading.Thread(target=consume)
        tp.start(); tc.start()
        tp.join(timeout=60); tc.join(timeout=60)
        assert not tp.is_alive() and not tc.is_alive()
        np.testing.assert_array_equal(np.array(got), payloads)
        r.close()
        w.close()

    def test_spin_time_observable(self, rng):
        uid = _uid()
        w = SymbolRing(uid, ROWS, COLS, LEN, master=True, timeout=5.0)
        r = SymbolRing(uid, ROWS, COLS, LEN, master=False, timeout=5.0)

        def delayed_write():
            import time
            time.sleep(0.05)
            w.write(_sym(rng))

        t = threading.Thread(target=delayed_write)
        t.start()
        r.read_next(cp=0)
        t.join()
        assert r.spin_seconds > 0.01
        r.close()
        w.close()


class TestCrossProcess:
    def test_two_processes(self, rng):
        """Real contract: producer and consumer in separate OS processes
        (the reference topology: RX writer process + demod reader process)."""
        import multiprocessing as mp

        uid = _uid()
        n = 4 * LEN
        ctx = mp.get_context("spawn")

        p = ctx.Process(target=_xproc_producer, args=(uid, n, ROWS, COLS, LEN))
        p.start()
        r = SymbolRing(uid, ROWS, COLS, LEN, master=False, timeout=90.0)
        vals = []
        for k in range(n):
            vals.append(r.read_next(cp=0)[0, 0].real)
        p.join(timeout=90)
        assert p.exitcode == 0
        np.testing.assert_array_equal(np.array(vals), np.arange(n, dtype=np.float32))
        r.close()


class TestBatchRead:
    def test_read_frame_matches_per_symbol(self, pair, rng):
        w, r = pair
        syms = [_sym(rng) for _ in range(LEN - 1)]
        for s in syms:
            w.write(s)
        re, im = r.read_frame_planar(LEN - 1, cp=CP)
        want = np.stack(syms)[:, :, CP:]
        np.testing.assert_array_equal(re + 1j * im, want)

    def test_read_frame_preallocated(self, pair, rng):
        w, r = pair
        syms = [_sym(rng) for _ in range(3)]
        for s in syms:
            w.write(s)
        keep = COLS - CP
        bre = np.empty((3, ROWS, keep), np.float32)
        bim = np.empty((3, ROWS, keep), np.float32)
        re, im = r.read_frame_planar(3, cp=CP, out_re=bre, out_im=bim)
        assert re is bre and im is bim
        np.testing.assert_array_equal(re + 1j * im, np.stack(syms)[:, :, CP:])

    def test_read_frame_times_out(self, pair):
        _, r = pair
        with pytest.raises(RingTimeout):
            r.read_frame_planar(2, cp=0, timeout=0.2)


class TestBatchWrite:
    def test_write_batch_matches_per_symbol(self, pair, rng):
        w, r = pair
        batch = np.stack([_sym(rng) for _ in range(LEN - 1)])
        assert w.write_batch(batch) == LEN - 1
        re, im = r.read_frame_planar(LEN - 1, cp=CP)
        np.testing.assert_array_equal(re + 1j * im, batch[:, :, CP:])

    def test_write_batch_shape_checked(self, pair, rng):
        w, _ = pair
        with pytest.raises(ValueError):
            w.write_batch(_sym(rng))  # 2-D: not a batch
        with pytest.raises(ValueError):
            w.write_batch(np.zeros((2, ROWS, COLS + 1), np.complex64))

    def test_write_batch_no_wait_drops_and_counts(self, pair, rng):
        w, r = pair
        batch = np.stack([_sym(rng) for _ in range(LEN - 1)])
        assert w.write_batch(batch, wait=False) == LEN - 1
        # Ring now holds LEN-1 of LEN slots: one more fits, the rest drop.
        wrote = w.write_batch(batch, wait=False)
        assert wrote == 1
        assert w.dropped == LEN - 2
        re, _ = r.read_frame_planar(LEN, cp=CP)
        np.testing.assert_array_equal(re[-1], batch[0].real[:, CP:])

    def test_write_batch_wait_times_out_with_prefix(self, pair, rng):
        w, r = pair
        batch = np.stack([_sym(rng) for _ in range(LEN - 1)])
        assert w.write_batch(batch) == LEN - 1
        # One free slot left: the waiting batch lands a prefix then times out.
        with pytest.raises(RingTimeout):
            w.write_batch(batch[:2], timeout=0.2)
        re, im = r.read_frame_planar(LEN, cp=CP)
        np.testing.assert_array_equal(
            re[-1] + 1j * im[-1], batch[0][:, CP:])


class TestReadLast:
    def test_read_last_skips_backlog(self, pair, rng):
        """readLastSymbol semantics (ShMemSymBuff.hpp:300-331; used per data
        symbol by the reference GPU loop, gpuLS.cu:419-424): deliver the
        freshest symbol, discard everything older."""
        w, r = pair
        syms = [_sym(rng) for _ in range(LEN - 1)]
        for s in syms:
            w.write(s)
        got = r.read_last(cp=0)
        np.testing.assert_array_equal(got, syms[-1])
        assert r.available == 0  # backlog consumed, not left behind

    def test_read_last_blocks_when_empty(self, pair, rng):
        w, r = pair
        with pytest.raises(RingTimeout):
            r.read_last(cp=0, timeout=0.2)

    def test_skip_discards_without_copy(self, pair, rng):
        w, r = pair
        syms = [_sym(rng) for _ in range(4)]
        for s in syms:
            w.write(s)
        assert r.skip(2) == 2
        np.testing.assert_array_equal(r.read_next(cp=0), syms[2])
        assert r.skip(10) == 1  # only one left; skip is clamped
        assert r.available == 0


class TestSc16Ring:
    """sc16 element format: int16 IQ in shm, float planar out (reference
    ShMemSymBuff_cucomplex templated element type; USRP wire format)."""

    @pytest.fixture
    def sc16_pair(self):
        uid = _uid()
        m = SymbolRing(uid, ROWS, COLS, LEN, master=True, timeout=5.0,
                       dtype="sc16")
        s = SymbolRing(uid, ROWS, COLS, LEN, master=False, timeout=5.0,
                       dtype="sc16")
        yield m, s
        s.close()
        m.close()

    def test_int16_roundtrip_scaled(self, sc16_pair, rng):
        w, r = sc16_pair
        iq = rng.integers(-32767, 32767, size=(ROWS, 2 * COLS), dtype=np.int16)
        w.write(iq)
        got = r.read_next(cp=0)
        want = (iq[:, 0::2] + 1j * iq[:, 1::2]).astype(np.complex64) / 32767.0
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_complex_write_converts(self, sc16_pair, rng):
        w, r = sc16_pair
        sym = (_sym(rng) / 8.0).astype(np.complex64)  # keep inside full scale
        w.write(sym)
        got = r.read_next(cp=CP)
        np.testing.assert_allclose(got, sym[:, CP:], atol=1.0 / 32767.0)

    def test_planar_read_and_cp_drop(self, sc16_pair, rng):
        w, r = sc16_pair
        sym = (_sym(rng) / 8.0).astype(np.complex64)
        w.write(sym)
        re, im = r.read_next_planar(cp=CP)
        np.testing.assert_allclose(re + 1j * im, sym[:, CP:], atol=1.0 / 32767.0)

    def test_write_batch_int16_and_complex(self, sc16_pair, rng):
        w, r = sc16_pair
        iq = rng.integers(-32767, 32767, size=(3, ROWS, 2 * COLS),
                          dtype=np.int16)
        assert w.write_batch(iq) == 3
        re, im = r.read_frame_planar(3, cp=0)
        want = (iq[..., 0::2] + 1j * iq[..., 1::2]).astype(np.complex64)
        np.testing.assert_allclose(re + 1j * im, want / 32767.0, atol=1e-6)
        csyms = np.stack([(_sym(rng) / 8.0) for _ in range(2)])
        assert w.write_batch(csyms) == 2
        re, im = r.read_frame_planar(2, cp=CP)
        np.testing.assert_allclose(re + 1j * im, csyms[:, :, CP:],
                                   atol=1.0 / 32767.0)

    def test_dtype_mismatch_rejected(self):
        uid = _uid()
        m = SymbolRing(uid, ROWS, COLS, LEN, master=True, timeout=5.0,
                       dtype="sc16")
        try:
            with pytest.raises(RingError):
                SymbolRing(uid, ROWS, COLS, LEN, master=False, timeout=0.5)
        finally:
            m.close()

    def test_mismatched_slave_cannot_damage_master(self, rng):
        """The shrink direction: a cf32 master must survive a smaller-footprint
        sc16 slave's failed attach (the slave must never ftruncate)."""
        uid = _uid()
        m = SymbolRing(uid, ROWS, COLS, LEN, master=True, timeout=5.0)
        try:
            with pytest.raises(RingError):
                SymbolRing(uid, ROWS, COLS, LEN, master=False, timeout=0.5,
                           dtype="sc16")
            # Master keeps working across the whole (untruncated) segment.
            r = SymbolRing(uid, ROWS, COLS, LEN, master=False, timeout=5.0)
            syms = [_sym(rng) for _ in range(LEN - 1)]
            for s in syms:
                m.write(s)  # would SIGBUS here if the segment had shrunk
            for s in syms:
                np.testing.assert_array_equal(r.read_next(cp=0), s)
            r.close()
        finally:
            m.close()


class TestCatchUpFeed:
    def test_feed_skips_stale_frames(self, rng):
        """catch_up=True drops whole queued frames and resumes at the freshest
        boundary (frame-level readLastSymbol semantics, gpuLS.cu:419-424)."""
        from ofdm_ls_mrc_tpu import FrameConfig
        from ofdm_ls_mrc_tpu.io.feed import RingFeed

        cfg = FrameConfig(num_antennas=ROWS, fft_size=COLS, cyclic_prefix=0,
                          frame_len=3)
        uid = _uid()
        cap = 4 * cfg.frame_len  # room for 4 whole frames
        w = SymbolRing(uid, ROWS, COLS, cap, master=True, timeout=10.0)
        r = SymbolRing(uid, ROWS, COLS, cap, master=False, timeout=10.0)
        try:
            # Producer races ahead: 3 full frames queued before any read.
            for k in range(3):
                for s in range(cfg.frame_len):
                    w.write(np.full((ROWS, COLS), float(k) + 1j * s, np.complex64))
            feed = RingFeed(r, cfg, catch_up=True)
            frame = next(feed.frames(max_frames=1))
            # Frames 0 and 1 skipped; delivered frame is the freshest (k=2).
            assert feed.skipped_frames == 2
            assert float(np.asarray(frame.re)[0, 0, 0]) == 2.0
            # Provenance: the writer-stream ordinal survives the skip.
            assert feed.last_frame_writer_seq == 2
            feed.stop()
        finally:
            r.close()
            w.close()

    def test_feed_no_skip_when_keeping_up(self, rng):
        from ofdm_ls_mrc_tpu import FrameConfig
        from ofdm_ls_mrc_tpu.io.feed import RingFeed

        cfg = FrameConfig(num_antennas=ROWS, fft_size=COLS, cyclic_prefix=0,
                          frame_len=3)
        uid = _uid()
        w = SymbolRing(uid, ROWS, COLS, 2 * cfg.frame_len, master=True, timeout=10.0)
        r = SymbolRing(uid, ROWS, COLS, 2 * cfg.frame_len, master=False, timeout=10.0)
        try:
            for s in range(cfg.frame_len):
                w.write(np.full((ROWS, COLS), 7.0 + 1j * s, np.complex64))
            feed = RingFeed(r, cfg, catch_up=True)
            frame = next(feed.frames(max_frames=1))
            assert feed.skipped_frames == 0
            assert float(np.asarray(frame.re)[0, 0, 0]) == 7.0
            assert feed.last_frame_writer_seq == 0
            feed.stop()
        finally:
            r.close()
            w.close()


class _ScriptedRing:
    """Duck-typed ring delivering a scripted consumer stream: each entry is
    (writer_stream_idx, dropped_total_after_this_read).  ``queued`` models
    how many of the upcoming entries are sitting in the ring when the feed
    resyncs (the drain skips exactly those).  Lets the feed's overrun-resync
    logic be tested deterministically (a real no-wait overrun race cannot
    pin WHERE in the backlog the drop lands)."""

    def __init__(self, rows, cols, stream, queued=0):
        self.rows, self.cols = rows, cols
        self._stream = list(stream)
        self._dropped = 0
        self._queued = queued

    def read_next_planar(self, cp=0):
        from ofdm_ls_mrc_tpu.io.ring import RingShutdown
        if not self._stream:
            raise RingShutdown("stream exhausted")
        idx, dropped = self._stream.pop(0)
        self._dropped = dropped
        self._queued = max(self._queued - 1, 0)
        re = np.full((self.rows, self.cols), float(idx), np.float32)
        return re, np.zeros_like(re)

    @property
    def dropped(self):
        return self._dropped

    @property
    def available(self):
        return min(self._queued, len(self._stream))

    def skip(self, n):
        k = min(n, self.available)
        for _ in range(k):
            self.read_next_planar()
        return k

    def shutdown(self):
        self._stream = []


class TestDropResync:
    def test_drop_discards_in_flight_frame_then_resyncs(self):
        """On a counter delta the in-flight frame is conservatively
        discarded (its read may have straddled the gap) and the resync
        discards to the writer-stream boundary so post-gap frames realign
        instead of silently decoding a shifted stream."""
        from ofdm_ls_mrc_tpu import FrameConfig
        from ofdm_ls_mrc_tpu.io.feed import RingFeed

        cfg = FrameConfig(num_antennas=ROWS, fft_size=COLS, cyclic_prefix=0,
                          frame_len=3)
        # Writer frames [0,1,2][3,4,5][6,7,8][9,10,11]; symbol 4 drops on
        # overrun while the reader is inside frame 0 (counter steps at the
        # read of idx 1).  Frame [0,1,2] is discarded; nothing is queued
        # when the resync runs, so the boundary discard consumes 3 and 5
        # (consumed=3 + dropped=1 -> 2 symbols to the next boundary).
        stream = [(0, 0), (1, 1), (2, 1),
                  (3, 1), (5, 1),
                  (6, 1), (7, 1), (8, 1),
                  (9, 1), (10, 1), (11, 1)]
        feed = RingFeed(_ScriptedRing(ROWS, COLS, stream), cfg)
        frames = [np.asarray(f.re)[:, 0, 0] for f in feed.frames(max_frames=2)]
        feed.stop()
        assert feed.drop_events == 1
        assert feed.resynced_frames == 1
        np.testing.assert_array_equal(frames[0], [6.0, 7.0, 8.0])  # realigned
        np.testing.assert_array_equal(frames[1], [9.0, 10.0, 11.0])

    def test_resync_drains_queued_backlog_first(self):
        """The gap sits INSIDE the queued backlog; the resync must drain it
        before the boundary discard (a boundary computed against stale
        backlog would deliver the corrupted frame as good data)."""
        from ofdm_ls_mrc_tpu import FrameConfig
        from ofdm_ls_mrc_tpu.io.feed import RingFeed

        cfg = FrameConfig(num_antennas=ROWS, fft_size=COLS, cyclic_prefix=0,
                          frame_len=3)
        # Frame [0,1,2] triggers (counter at 1 from a drop of idx 7) and is
        # discarded; symbols 3,4,5,6,8 are queued: the drain consumes them,
        # leaving consumed=8, dropped=1 -> boundary at (8+1)%3=0, so frame
        # [9,10,11] follows immediately.
        stream = [(0, 0), (1, 1), (2, 1),
                  (3, 1), (4, 1), (5, 1), (6, 1), (8, 1),
                  (9, 1), (10, 1), (11, 1)]
        feed = RingFeed(_ScriptedRing(ROWS, COLS, stream, queued=8), cfg)
        frames = [np.asarray(f.re)[:, 0, 0] for f in feed.frames(max_frames=1)]
        feed.stop()
        assert feed.drop_events == 1
        np.testing.assert_array_equal(frames[0], [9.0, 10.0, 11.0])

    def test_whole_frame_drop_realigns_without_extra_discard(self):
        """Drops in whole-frame multiples keep alignment: after the drain
        the boundary discard is zero symbols, so only the triggering frame
        is lost and the next frame is delivered as-is."""
        from ofdm_ls_mrc_tpu import FrameConfig
        from ofdm_ls_mrc_tpu.io.feed import RingFeed

        cfg = FrameConfig(num_antennas=ROWS, fft_size=COLS, cyclic_prefix=0,
                          frame_len=3)
        stream = [(0, 0), (1, 0), (2, 3),      # frame 1 (idx 3-5) dropped
                  (6, 3), (7, 3), (8, 3)]
        feed = RingFeed(_ScriptedRing(ROWS, COLS, stream), cfg)
        frames = [np.asarray(f.re)[:, 0, 0] for f in feed.frames(max_frames=1)]
        feed.stop()
        assert feed.drop_events == 1
        np.testing.assert_array_equal(frames[0], [6.0, 7.0, 8.0])

    def test_attach_after_overrun_resyncs_first(self):
        """A reader attaching to a ring that ALREADY overran must resync
        before delivering: the backlog predates the drops (the writer drops
        NEW symbols when full), so it is stale and the writer-seq identity
        (consumed + dropped = attempt cursor) doesn't hold until the reader
        drains to the write head.  Without the startup resync the first
        frame would be stale frame 0 claiming writer-seq dropped//frame_len."""
        import threading

        from ofdm_ls_mrc_tpu import FrameConfig
        from ofdm_ls_mrc_tpu.io.feed import RingFeed

        cfg = FrameConfig(num_antennas=ROWS, fft_size=COLS, cyclic_prefix=0,
                          frame_len=3)
        uid = _uid()
        cap = cfg.frame_len  # one-frame ring: overruns immediately
        w = SymbolRing(uid, ROWS, COLS, cap, master=True, timeout=10.0)
        r = SymbolRing(uid, ROWS, COLS, cap, master=False, timeout=10.0)
        try:
            # Writer frame 0 stored, frame 1 dropped entirely (no reader yet).
            for k in (0, 1):
                for s in range(cfg.frame_len):
                    w.write(np.full((ROWS, COLS), float(k) + 1j * s,
                                    np.complex64), wait=False)
            assert w.dropped == cfg.frame_len
            # Frame 2 arrives once the startup resync drains the stale frame.
            t = threading.Thread(target=lambda: [
                w.write(np.full((ROWS, COLS), 2.0 + 1j * s, np.complex64),
                        wait=True) for s in range(cfg.frame_len)])
            t.start()
            feed = RingFeed(r, cfg)
            frame = next(feed.frames(max_frames=1))
            t.join()
            # Stale frame 0 drained, dropped frame 1 accounted behind the
            # cursor: the delivered frame is frame 2 and says so.
            assert float(np.asarray(frame.re)[0, 0, 0]) == 2.0
            assert feed.last_frame_writer_seq == 2
            assert not feed.last_frame_dirty
            assert feed.resynced_frames == 1 and feed.drop_events == 0
            feed.stop()
        finally:
            r.close()
            w.close()

    def test_feed_writer_seq_after_prior_consumer(self):
        """A feed attaching to a ring a PREVIOUS consumer already read from
        seeds its writer-stream cursor from the ring's monotonic tail: the
        provenance ordinal is the TRUE writer frame index, not an ordinal
        relative to this reader's attach point."""
        from ofdm_ls_mrc_tpu import FrameConfig
        from ofdm_ls_mrc_tpu.io.feed import RingFeed

        cfg = FrameConfig(num_antennas=ROWS, fft_size=COLS, cyclic_prefix=0,
                          frame_len=3)
        uid = _uid()
        cap = 4 * cfg.frame_len
        w = SymbolRing(uid, ROWS, COLS, cap, master=True, timeout=10.0)
        r = SymbolRing(uid, ROWS, COLS, cap, master=False, timeout=10.0)
        try:
            for k in range(3):
                for s in range(cfg.frame_len):
                    w.write(np.full((ROWS, COLS), float(k) + 1j * s,
                                    np.complex64))
            # A prior consumer read frame 0 whole and exited.
            assert r.skip(cfg.frame_len) == cfg.frame_len
            assert r.consumed == cfg.frame_len
            feed = RingFeed(r, cfg)
            frame = next(feed.frames(max_frames=1))
            assert float(np.asarray(frame.re)[0, 0, 0]) == 1.0
            assert feed.last_frame_writer_seq == 1
            feed.stop()
        finally:
            r.close()
            w.close()

    def test_feed_realigns_after_mid_frame_consumer_exit(self):
        """A prior consumer that exited MID-frame (no drops) leaves the tail
        off a frame boundary; the attaching feed discards only up to the
        next writer-stream boundary (no backlog drain) and delivers aligned
        frames with correct ordinals."""
        from ofdm_ls_mrc_tpu import FrameConfig
        from ofdm_ls_mrc_tpu.io.feed import RingFeed

        cfg = FrameConfig(num_antennas=ROWS, fft_size=COLS, cyclic_prefix=0,
                          frame_len=3)
        uid = _uid()
        cap = 4 * cfg.frame_len
        w = SymbolRing(uid, ROWS, COLS, cap, master=True, timeout=10.0)
        r = SymbolRing(uid, ROWS, COLS, cap, master=False, timeout=10.0)
        try:
            for k in range(3):
                for s in range(cfg.frame_len):
                    w.write(np.full((ROWS, COLS), float(k) + 1j * s,
                                    np.complex64))
            # Prior consumer stopped one symbol INTO frame 1.
            assert r.skip(cfg.frame_len + 1) == cfg.frame_len + 1
            feed = RingFeed(r, cfg)
            frame = next(feed.frames(max_frames=1))
            # The rest of frame 1 is discarded; frame 2 arrives aligned.
            assert float(np.asarray(frame.re)[0, 0, 0]) == 2.0
            assert float(np.asarray(frame.im)[0, 0, 0]) == 0.0
            assert feed.last_frame_writer_seq == 2
            feed.stop()
        finally:
            r.close()
            w.close()


    def test_feed_misaligned_after_resync_giveup_is_dirty(self):
        """When every resync pass sees fresh drops (give-up path), the
        cursor can be left OFF a frame boundary; frames read from there must
        be delivered DIRTY even if no new drops land during their read --
        otherwise a burst that outruns the resync then stops would stream
        permanently misaligned frames flagged clean."""
        from ofdm_ls_mrc_tpu import FrameConfig
        from ofdm_ls_mrc_tpu.io.feed import RingFeed

        fl = 3
        # Frame 0's read trips a drop -> resync; drops land on each of the
        # 3 resync passes (give-up, cursor misaligned: (consumed+dropped)
        # % fl == 1); then the drop counter goes quiet.
        stream = ([(0, 0), (1, 0), (2, 1),           # trip
                   (3, 2), (4, 2), (5, 3), (6, 3), (7, 4), (8, 4)]  # resyncs
                  + [(9 + i, 4) for i in range(8)])  # quiet tail
        scripted = _ScriptedRing(ROWS, COLS, stream)
        cfg = FrameConfig(num_antennas=ROWS, fft_size=COLS, cyclic_prefix=0,
                          frame_len=fl)
        feed = RingFeed(scripted, cfg)
        it = feed.frames(max_frames=2)
        first = next(it)
        assert feed.last_frame_dirty          # misaligned, never clean
        assert float(np.asarray(first.re)[0, 0, 0]) == 9.0
        second = next(it)
        # The flagged frame re-triggers a resync; the boundary discard
        # realigns and the next frame is clean again.
        assert not feed.last_frame_dirty
        assert float(np.asarray(second.re)[0, 0, 0]) == 14.0
        assert (feed.dirty_frames, feed.resynced_frames) == (1, 2)
        feed.stop()

    def test_feed_frames_is_one_shot(self):
        from ofdm_ls_mrc_tpu import FrameConfig
        from ofdm_ls_mrc_tpu.io.feed import RingFeed

        fl = 2
        scripted = _ScriptedRing(ROWS, COLS, [(i, 0) for i in range(2 * fl)])
        cfg = FrameConfig(num_antennas=ROWS, fft_size=COLS, cyclic_prefix=0,
                          frame_len=fl)
        feed = RingFeed(scripted, cfg)
        next(feed.frames(max_frames=1))
        with pytest.raises(RuntimeError, match="already consumed"):
            next(feed.frames(max_frames=1))
        feed.stop()

    def test_int16_feed_rejects_cf32_ring(self):
        from ofdm_ls_mrc_tpu import FrameConfig
        from ofdm_ls_mrc_tpu.io.feed import RingFeed

        cfg = FrameConfig(num_antennas=ROWS, fft_size=COLS, cyclic_prefix=0,
                          frame_len=3)
        uid = _uid()
        w = SymbolRing(uid, ROWS, COLS, 6, master=True, timeout=5.0)
        try:
            with pytest.raises(ValueError, match="requires an sc16 ring"):
                RingFeed(w, cfg, int16=True)
        finally:
            w.close()

    def test_master_restart_gets_fresh_segment(self):
        """A restarting master must NOT re-initialize a stale segment in
        place (a concurrently-attaching slave could pass the size>0 gate on
        the stale header mid-rewrite): it unlinks and creates a fresh inode,
        so writes through a leaked old handle never reach the new ring."""
        uid = _uid()
        sym = np.ones((ROWS, COLS), np.complex64)
        m1 = SymbolRing(uid, ROWS, COLS, LEN, master=True, timeout=5.0)
        m1.write(sym)
        m1.write(sym)
        # "Crashed" producer: segment left published with head=2.  The new
        # master starts a brand-new segment under the same name.
        m2 = SymbolRing(uid, ROWS, COLS, LEN, master=True, timeout=5.0)
        r2 = SymbolRing(uid, ROWS, COLS, LEN, master=False, timeout=5.0)
        try:
            assert r2.available == 0          # stale backlog invisible
            m1.write(sym)                     # old inode: must not surface
            assert r2.available == 0
            m2.write(2 * sym)
            got = r2.read_next(cp=0)
            np.testing.assert_array_equal(got, 2 * sym)
        finally:
            r2.close()
            m2.close()
            # m1 maps the unlinked old inode; closing is still safe.
            m1.close()

    def test_master_close_raises_shutdown_sentinel(self):
        """A blocked reader observes the MASTER's exit immediately
        (RingShutdown) instead of burning its full timeout."""
        uid = _uid()
        m = SymbolRing(uid, ROWS, COLS, LEN, master=True, timeout=5.0)
        r = SymbolRing(uid, ROWS, COLS, LEN, master=False, timeout=30.0)
        exc = []

        def read():
            try:
                r.read_next(cp=0, timeout=20.0)
            except RingShutdown as e:
                exc.append(e)

        t = threading.Thread(target=read)
        t.start()
        import time as _time
        _time.sleep(0.2)
        t0 = _time.monotonic()
        m.close()
        t.join(timeout=5.0)
        assert not t.is_alive() and exc
        assert _time.monotonic() - t0 < 5.0
        r.close()

    def test_accessors_after_close_do_not_crash(self):
        uid = _uid()
        m = SymbolRing(uid, ROWS, COLS, LEN, master=True, timeout=5.0)
        m.close()
        assert m.dropped == 0 and m.available == 0 and m.consumed == 0
        assert m.spin_seconds == 0.0
        m.close()   # idempotent

    def test_read_frame_partial_timeout_reports_consumption(self):
        """A timeout that interrupts a partially-read frame reports the
        mid-frame consumption (the tail advanced INTO a frame) instead of a
        plain timeout a caller might blindly retry after."""
        uid = _uid()
        m = SymbolRing(uid, ROWS, COLS, LEN, master=True, timeout=5.0)
        r = SymbolRing(uid, ROWS, COLS, LEN, master=False, timeout=5.0)
        try:
            sym = np.ones((ROWS, COLS), np.complex64)
            m.write(sym)   # 1 of the 3 requested symbols
            with pytest.raises(RingTimeout, match="mid-frame after 1/3"):
                r.read_frame_planar(3, cp=0, timeout=0.3)
        finally:
            r.close()
            m.close()

    def test_zero_timeout_means_immediate(self):
        """timeout=0.0 is an explicit non-blocking poll, not 'use the
        default' -- a falsy-zero bug here stalls teardown paths 30 s."""
        import time as _time
        uid = _uid()
        w = SymbolRing(uid, ROWS, COLS, 2, master=True, timeout=30.0)
        r = SymbolRing(uid, ROWS, COLS, 2, master=False, timeout=30.0)
        try:
            sym = np.ones((ROWS, COLS), np.complex64)
            w.write(sym)
            w.write(sym)                       # ring now full, unread
            t0 = _time.monotonic()
            assert w.wait_drained(timeout=0.0) is False
            with pytest.raises(RingTimeout):
                w.write(sym, wait=True, timeout=0.0)
            assert _time.monotonic() - t0 < 5.0
        finally:
            r.close()
            w.close()


def _xproc_producer(uid, n, rows, cols, length):
    import numpy as np
    from ofdm_ls_mrc_tpu.io.ring import SymbolRing
    w = SymbolRing(uid, rows, cols, length, master=True, timeout=90.0)
    for k in range(n):
        w.write(np.full((rows, cols), float(k) + 1j, np.complex64), wait=True)
    w.close()


def test_tsan_soak():
    """Run the C++ producer/consumer soak under ThreadSanitizer: the ring's
    atomic head/tail protocol must be race-free (the reference's plain-int
    cursors would be flagged immediately)."""
    import subprocess
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    r = subprocess.run(["make", "-s", "-C", os.path.join(repo, "native"),
                        "tsan_test"], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ring_test OK" in r.stdout
    assert "WARNING: ThreadSanitizer" not in r.stderr


class TestSc16NativeRead:
    @pytest.fixture
    def sc16_pair(self):
        uid = _uid()
        m = SymbolRing(uid, ROWS, COLS, LEN, master=True, timeout=5.0,
                       dtype="sc16")
        s = SymbolRing(uid, ROWS, COLS, LEN, master=False, timeout=5.0,
                       dtype="sc16")
        yield m, s
        s.close()
        m.close()

    def test_int16_batch_read_exact(self, sc16_pair, rng):
        """read_frame_planar_i16 returns the EXACT wire int16 (no float
        conversion), deinterleaved planar with CP dropped."""
        w, r = sc16_pair
        iq = rng.integers(-32767, 32767, (3, ROWS, COLS, 2)).astype(np.int16)
        for k in range(3):
            w.write(np.ascontiguousarray(iq[k].reshape(ROWS, -1)))
        re, im = r.read_frame_planar_i16(3, cp=CP)
        np.testing.assert_array_equal(re, iq[:, :, CP:, 0])
        np.testing.assert_array_equal(im, iq[:, :, CP:, 1])

    def test_rejected_on_cf32_ring(self, pair):
        from ofdm_ls_mrc_tpu.io.ring import RingError
        _, r = pair
        with pytest.raises(RingError):
            r.read_frame_planar_i16(1)

    def test_int16_per_symbol_read_exact(self, sc16_pair, rng):
        """read_next_planar_i16: one symbol's EXACT wire int16 planes with
        CP dropped (the per-symbol low-latency sc16 feed; the reference
        per-symbol loop moves the ring's native element type untouched,
        ShMemSymBuff_cucomplex.hpp:256-257)."""
        w, r = sc16_pair
        iq = rng.integers(-32767, 32767, (3, ROWS, COLS, 2)).astype(np.int16)
        for k in range(3):
            w.write(np.ascontiguousarray(iq[k].reshape(ROWS, -1)))
        for k in range(3):
            re, im = r.read_next_planar_i16(cp=CP)
            assert re.dtype == np.int16 and re.shape == (ROWS, COLS - CP)
            np.testing.assert_array_equal(re, iq[k, :, CP:, 0])
            np.testing.assert_array_equal(im, iq[k, :, CP:, 1])
        assert r.available == 0

    def test_int16_read_last_discards_backlog(self, sc16_pair, rng):
        """read_last_planar_i16: readLastSymbol semantics
        (ShMemSymBuff.hpp:300-331) -- freshest symbol as int16 planes,
        older backlog silently consumed."""
        w, r = sc16_pair
        iq = rng.integers(-32767, 32767, (3, ROWS, COLS, 2)).astype(np.int16)
        for k in range(3):
            w.write(np.ascontiguousarray(iq[k].reshape(ROWS, -1)))
        re, im = r.read_last_planar_i16(cp=CP)
        np.testing.assert_array_equal(re, iq[2, :, CP:, 0])
        np.testing.assert_array_equal(im, iq[2, :, CP:, 1])
        assert r.available == 0

    def test_per_symbol_i16_rejected_on_cf32_ring(self, pair):
        from ofdm_ls_mrc_tpu.io.ring import RingError
        _, r = pair
        with pytest.raises(RingError):
            r.read_next_planar_i16()
        with pytest.raises(RingError):
            r.read_last_planar_i16()

    def test_per_symbol_i16_timeout(self, sc16_pair):
        from ofdm_ls_mrc_tpu.io.ring import RingTimeout
        _, r = sc16_pair
        with pytest.raises(RingTimeout):
            r.read_next_planar_i16(timeout=0.05)


def test_real_ring_overrun_recovery(rng):
    """Property test against the REAL ring: a no-wait writer overruns a
    small ring while the reader is stalled; every frame the feed delivers
    afterwards must be writer-frame aligned (first symbol index % fl == 0,
    contiguous within the frame)."""
    from ofdm_ls_mrc_tpu import FrameConfig
    from ofdm_ls_mrc_tpu.io.feed import RingFeed

    fl = 3
    cfg = FrameConfig(num_antennas=ROWS, fft_size=COLS, cyclic_prefix=0,
                      frame_len=fl)
    uid = _uid()
    cap = 4  # NOT a frame multiple: drops won't be frame-aligned
    w = SymbolRing(uid, ROWS, COLS, cap, master=True, timeout=10.0)
    r = SymbolRing(uid, ROWS, COLS, cap, master=False, timeout=10.0)

    def sym(idx):
        return np.full((ROWS, COLS), float(idx) + 1j, np.complex64)

    try:
        # Frame 0 written with backpressure; the feed consumes it first so
        # the overrun happens while the feed is LIVE (its drop baseline is
        # snapshotted at stream start).
        idx = 0
        for _ in range(fl):
            w.write(sym(idx), wait=True)
            idx += 1
        feed = RingFeed(r, cfg)
        gen = feed.frames(max_frames=4)
        first = next(gen)
        np.testing.assert_array_equal(np.asarray(first.re)[:, 0, 0], [0, 1, 2])
        # Burst 8 frames without waiting: capacity 4 forces mid-stream drops
        # at arbitrary (non-frame-aligned) positions.
        for _ in range(8 * fl):
            w.write(sym(idx), wait=False)
            idx += 1
        assert w.dropped > 0
        # Writer then trickles with backpressure so the reader can finish.
        stop = threading.Event()

        def trickle():
            i = idx
            while not stop.is_set():
                try:
                    w.write(sym(i), wait=True, timeout=0.2)
                    i += 1
                except Exception:
                    continue

        t = threading.Thread(target=trickle, daemon=True)
        t.start()
        delivered = [np.asarray(f.re)[:, 0, 0] for f in gen]
        feed.stop()
        stop.set()
        t.join(timeout=5)
        assert feed.drop_events >= 1
        # The sustained-overrun path may deliberately deliver best-effort
        # (possibly misaligned) frames -- every OTHER frame must be
        # writer-aligned and contiguous, and dirty deliveries are bounded
        # by the dirty counter.
        misaligned = sum(
            1 for fr in delivered
            if fr[0] % fl != 0 or not np.array_equal(fr, fr[0] + np.arange(fl)))
        assert misaligned <= feed.dirty_frames, (
            f"{misaligned} misaligned frames but only {feed.dirty_frames} "
            f"counted dirty")
    finally:
        r.close()
        w.close()


def test_sustained_overrun_does_not_livelock():
    """When drops land on EVERY frame (producer systematically faster), the
    feed must deliver best-effort frames (counted dirty) instead of
    livelocking in a discard/resync loop with zero output."""
    from ofdm_ls_mrc_tpu import FrameConfig
    from ofdm_ls_mrc_tpu.io.feed import RingFeed

    fl = 3
    cfg = FrameConfig(num_antennas=ROWS, fft_size=COLS, cyclic_prefix=0,
                      frame_len=fl)
    # Counter increments at every 3rd read: every frame sees a fresh delta.
    stream = [(i, 1 + i // fl) for i in range(60)]
    feed = RingFeed(_ScriptedRing(ROWS, COLS, stream), cfg)
    frames, dirty_flags = [], []
    for f in feed.frames(max_frames=2):
        frames.append(np.asarray(f.re)[:, 0, 0])
        dirty_flags.append(feed.last_frame_dirty)
    feed.stop()
    assert len(frames) == 2, "feed livelocked under sustained overrun"
    assert feed.dirty_frames >= 1
    assert feed.drop_events >= 2
    # Per-frame provenance: every best-effort delivery is flagged on the
    # frame itself (not just the aggregate counter) so consumers can drop
    # or index dirty frames.  In this scripted stream
    # every delivered frame is best-effort; the counter may run ahead of
    # the flags (the reader thread fills one frame beyond the consumer).
    assert dirty_flags == [True, True]
    assert feed.dirty_frames >= sum(dirty_flags)
