"""ctypes bindings to the native C++ shared-memory symbol ring.

The native library (native/shm_ring/shm_ring.cpp) re-implements the
reference's IPC transport (CSharedMemSimple + ShMemSymBuff protocol,
ShMemSymBuff.hpp:193-484) with std::atomic correctness, timeouts, and a
planar-deinterleaving read path that hands the device feed (re, im)
float32 planes directly.

The .so is built on demand with the repo's native/Makefile (g++ is part of
the toolchain contract); no pip packages involved.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from ._native import load_native

RING_OK = 0
RING_TIMEOUT = -1
RING_SHUTDOWN = -2
RING_BADARG = -3
RING_OVERRUN = -4

_lib = None
_lib_lock = threading.Lock()


class RingError(RuntimeError):
    pass


class RingTimeout(RingError):
    pass


class RingShutdown(RingError):
    pass


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = load_native("libshm_ring.so", "shm_ring/shm_ring.cpp")
        lib.ring_open.restype = ctypes.c_void_p
        lib.ring_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_double]
        lib.ring_open_fmt.restype = ctypes.c_void_p
        lib.ring_open_fmt.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_double, ctypes.c_int]
        lib.ring_close.argtypes = [ctypes.c_void_p]
        lib.ring_shutdown.argtypes = [ctypes.c_void_p]
        for name in ("ring_rows", "ring_cols", "ring_len", "ring_dropped",
                     "ring_available"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p]
        lib.ring_spin_seconds.restype = ctypes.c_double
        lib.ring_spin_seconds.argtypes = [ctypes.c_void_p]
        lib.ring_consumed.restype = ctypes.c_int64
        lib.ring_consumed.argtypes = [ctypes.c_void_p]
        lib.ring_wait_drained.restype = ctypes.c_int
        lib.ring_wait_drained.argtypes = [ctypes.c_void_p, ctypes.c_double]
        fptr = ctypes.POINTER(ctypes.c_float)
        lib.ring_write.restype = ctypes.c_int
        lib.ring_write.argtypes = [ctypes.c_void_p, fptr, ctypes.c_int,
                                   ctypes.c_double]
        lib.ring_write_sc16.restype = ctypes.c_int
        lib.ring_write_sc16.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int16),
                                        ctypes.c_int, ctypes.c_double]
        lib.ring_write_batch.restype = ctypes.c_int
        lib.ring_write_batch.argtypes = [ctypes.c_void_p, fptr, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_double]
        lib.ring_write_batch_sc16.restype = ctypes.c_int
        lib.ring_write_batch_sc16.argtypes = [ctypes.c_void_p,
                                              ctypes.POINTER(ctypes.c_int16),
                                              ctypes.c_int, ctypes.c_int,
                                              ctypes.c_double]
        for name in ("ring_read_next", "ring_read_last"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, fptr, ctypes.c_int, ctypes.c_int,
                           ctypes.c_double]
        lib.ring_read_frame.restype = ctypes.c_int
        lib.ring_read_frame.argtypes = [ctypes.c_void_p, fptr, fptr,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_double]
        i16ptr = ctypes.POINTER(ctypes.c_int16)
        lib.ring_read_frame_i16.restype = ctypes.c_int
        lib.ring_read_frame_i16.argtypes = [ctypes.c_void_p, i16ptr, i16ptr,
                                            ctypes.c_int, ctypes.c_int,
                                            ctypes.c_double]
        for name in ("ring_read_next_i16", "ring_read_last_i16"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, i16ptr, i16ptr, ctypes.c_int,
                           ctypes.c_double]
        lib.ring_skip.restype = ctypes.c_int
        lib.ring_skip.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return lib


def _check(rc: int, what: str) -> None:
    if rc == RING_OK:
        return
    if rc == RING_TIMEOUT:
        raise RingTimeout(f"{what} timed out")
    if rc == RING_SHUTDOWN:
        raise RingShutdown(f"{what}: ring shut down")
    raise RingError(f"{what} failed with code {rc}")


class SymbolRing:
    """One end of the producer/consumer symbol ring.

    Mirrors the reference's master/slave roles (master creates and unlinks
    the segment -- the RX/ingest process, rx_and_corr.cpp:52,302; the demod
    process attaches as slave, cpuLS_main.cpp:76).

    Args:
      uid:    shm name, e.g. "/ofdm_ring" (reference "/blah", ShMemSymBuff.hpp:69).
      rows:   antennas per symbol.
      cols:   samples per row INCLUDING cyclic prefix.
      length: ring slots (lenOfBuffer).
      master: True to create/initialize the segment.
      timeout: default spin-wait timeout in seconds.
      dtype:  shm element format: "complex64" (default) or "sc16"
              (interleaved int16 IQ, the USRP wire format -- half the shm
              bandwidth; reads convert to float with the UHD full-scale
              1/32767 during the native copy-out).  The reference's
              ShMemSymBuff_cucomplex templates the ring on element type.
    """

    _FMTS = {"complex64": 0, "sc16": 1}

    def __init__(self, uid: str, rows: int, cols: int, length: int,
                 master: bool, timeout: float = 30.0,
                 dtype: str = "complex64"):
        self._lib = _load()
        self._timeout = float(timeout)
        self.rows, self.cols, self.length = rows, cols, length
        self.uid = uid
        if dtype not in self._FMTS:
            raise ValueError(f"dtype must be one of {sorted(self._FMTS)}")
        self.dtype = dtype
        handle = self._lib.ring_open_fmt(uid.encode(), rows, cols, length,
                                         1 if master else 0, self._timeout,
                                         self._FMTS[dtype])
        if not handle:
            raise RingError(
                f"ring_open({uid!r}) failed"
                + ("" if master else
                   " (master not up within timeout, or geometry/dtype mismatch?)"))
        self._handle = ctypes.c_void_p(handle)
        self.master = master

    # -- producer side ---------------------------------------------------------
    def write(self, symbol: np.ndarray, wait: bool = True,
              timeout: Optional[float] = None) -> bool:
        """Write one [rows, cols] complex64 symbol.

        wait=True  -> writeNextSymbolWithWait (backpressure on the reader).
        wait=False -> writeNextSymbolNoWait (live path): on a full ring the
                      symbol is dropped, the overrun counted, and False
                      returned -- never blocks.

        On an sc16 ring, pass either an int16 array of shape [rows, 2*cols]
        (interleaved IQ, as received off the wire) or complex64 (converted
        with the UHD full-scale factor here).
        """
        if self.dtype == "sc16":
            symbol = np.asarray(symbol)
            if symbol.dtype == np.int16:
                sym = np.ascontiguousarray(symbol)
                if sym.shape != (self.rows, 2 * self.cols):
                    raise ValueError(
                        f"sc16 symbol shape {sym.shape} != ({self.rows}, {2 * self.cols})")
            else:
                from ..golden.io import complex_to_sc16
                c = np.ascontiguousarray(symbol, dtype=np.complex64)
                if c.shape != (self.rows, self.cols):
                    raise ValueError(
                        f"symbol shape {c.shape} != ({self.rows}, {self.cols})")
                sym = complex_to_sc16(c)
            rc = self._lib.ring_write_sc16(
                self._handle, sym.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                1 if wait else 0, (self._timeout if timeout is None else timeout))
        else:
            sym = np.ascontiguousarray(symbol, dtype=np.complex64)
            if sym.shape != (self.rows, self.cols):
                raise ValueError(f"symbol shape {sym.shape} != ({self.rows}, {self.cols})")
            buf = sym.view(np.float32)
            rc = self._lib.ring_write(
                self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                1 if wait else 0, (self._timeout if timeout is None else timeout))
        if rc == RING_OVERRUN and not wait:
            return False
        _check(rc, "ring_write")
        return True

    def write_batch(self, symbols: np.ndarray, wait: bool = True,
                    timeout: Optional[float] = None) -> int:
        """Write n contiguous symbols in ONE native call; returns the count
        actually written.

        The producer analogue of ``read_frame_planar``: an ingest process
        extracts many symbols per radio recv buffer, and per-symbol
        ``write`` calls pay a foreign-call overhead each that outweighs
        the symbol's memcpy.

        ``symbols`` is [n, rows, cols] complex64, or on an sc16 ring either
        [n, rows, 2*cols] int16 (interleaved IQ off the wire) or complex64
        (converted here).  wait=False never blocks: full-ring symbols are
        dropped and counted (the reference's writeNextSymbolNoWait
        semantics, per symbol), and the returned count may be < n.
        """
        if self.dtype == "sc16":
            symbols = np.asarray(symbols)
            if symbols.dtype == np.int16:
                syms = np.ascontiguousarray(symbols)
                if syms.ndim != 3 or syms.shape[1:] != (self.rows,
                                                        2 * self.cols):
                    raise ValueError(f"sc16 batch shape {syms.shape} != "
                                     f"(n, {self.rows}, {2 * self.cols})")
            else:
                from ..golden.io import complex_to_sc16
                c = np.ascontiguousarray(symbols, dtype=np.complex64)
                if c.ndim != 3 or c.shape[1:] != (self.rows, self.cols):
                    raise ValueError(f"batch shape {c.shape} != "
                                     f"(n, {self.rows}, {self.cols})")
                syms = complex_to_sc16(c)
            rc = self._lib.ring_write_batch_sc16(
                self._handle,
                syms.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                syms.shape[0], 1 if wait else 0, (self._timeout if timeout is None else timeout))
        else:
            syms = np.ascontiguousarray(symbols, dtype=np.complex64)
            if syms.ndim != 3 or syms.shape[1:] != (self.rows, self.cols):
                raise ValueError(f"batch shape {syms.shape} != "
                                 f"(n, {self.rows}, {self.cols})")
            buf = syms.view(np.float32)
            rc = self._lib.ring_write_batch(
                self._handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                syms.shape[0], 1 if wait else 0, (self._timeout if timeout is None else timeout))
        if rc < 0:
            _check(rc, "ring_write_batch")
        return rc

    # -- consumer side ---------------------------------------------------------
    def _read(self, fn, cp: int, planar: bool, timeout: Optional[float]):
        keep = self.cols - cp
        if planar:
            out = np.empty((2, self.rows, keep), dtype=np.float32)
        else:
            out = np.empty((self.rows, keep), dtype=np.complex64)
        buf = out.view(np.float32)
        rc = fn(self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                cp, 1 if planar else 0, (self._timeout if timeout is None else timeout))
        _check(rc, fn.__name__ if hasattr(fn, "__name__") else "ring_read")
        return out

    def read_next(self, cp: int = 0, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking read of the next symbol, CP dropped: [rows, cols-cp] complex64."""
        return self._read(self._lib.ring_read_next, cp, False, timeout)

    def read_next_planar(self, cp: int = 0,
                         timeout: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking read deinterleaved to planar: (re, im) float32 [rows, cols-cp]."""
        out = self._read(self._lib.ring_read_next, cp, True, timeout)
        return out[0], out[1]

    def read_frame_planar(self, n: int, cp: int = 0,
                          out_re: Optional[np.ndarray] = None,
                          out_im: Optional[np.ndarray] = None,
                          timeout: Optional[float] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch read: n symbols into planar frame planes [n, rows, cols-cp].

        One native call spin-waits and copies per symbol -- the low-overhead
        bulk ingest path for whole-frame consumers (io/feed.py).  Pass
        preallocated C-contiguous float32 buffers to avoid allocation.
        """
        keep = self.cols - cp
        shape = (n, self.rows, keep)
        if out_re is None:
            out_re = np.empty(shape, np.float32)
        if out_im is None:
            out_im = np.empty(shape, np.float32)
        for name, buf in (("out_re", out_re), ("out_im", out_im)):
            if buf.shape != shape:
                raise ValueError(f"{name} must have shape {shape}")
            if buf.dtype != np.float32 or not buf.flags["C_CONTIGUOUS"]:
                raise ValueError(f"{name} must be C-contiguous float32")
        rc = self._lib.ring_read_frame(
            self._handle, out_re.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out_im.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, cp, (self._timeout if timeout is None else timeout))
        if 0 < rc < n:
            # Timeout mid-frame: the cursor advanced rc symbols INTO a frame
            # (those symbols are consumed and gone), so a retry would read
            # misaligned frames.  Raise a timeout the caller can see carries
            # a partial consumption.
            raise RingTimeout(
                f"ring_read_frame timed out mid-frame after {rc}/{n} "
                f"symbols (stream no longer frame-aligned)")
        _check(rc, "ring_read_frame")
        return out_re, out_im

    def read_frame_planar_i16(self, n: int, cp: int = 0,
                              out_re: Optional[np.ndarray] = None,
                              out_im: Optional[np.ndarray] = None,
                              timeout: Optional[float] = None
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """sc16-native batch read: n symbols deinterleaved into planar INT16
        planes [n, rows, cols-cp] without float conversion -- the
        half-bandwidth feed for device bodies that widen sc16 in-jit
        (ops/modulate.widen_sc16).  Only valid on sc16 rings."""
        if self.dtype != "sc16":
            raise RingError("read_frame_planar_i16 requires an sc16 ring")
        keep = self.cols - cp
        shape = (n, self.rows, keep)
        if out_re is None:
            out_re = np.empty(shape, np.int16)
        if out_im is None:
            out_im = np.empty(shape, np.int16)
        for name, buf in (("out_re", out_re), ("out_im", out_im)):
            if buf.shape != shape:
                raise ValueError(f"{name} must have shape {shape}")
            if buf.dtype != np.int16 or not buf.flags["C_CONTIGUOUS"]:
                raise ValueError(f"{name} must be C-contiguous int16")
        p16 = ctypes.POINTER(ctypes.c_int16)
        rc = self._lib.ring_read_frame_i16(
            self._handle, out_re.ctypes.data_as(p16),
            out_im.ctypes.data_as(p16), n, cp, (self._timeout if timeout is None else timeout))
        if 0 < rc < n:
            raise RingTimeout(
                f"ring_read_frame_i16 timed out mid-frame after {rc}/{n} "
                f"symbols (stream no longer frame-aligned)")
        _check(rc, "ring_read_frame_i16")
        return out_re, out_im

    def skip(self, n: int) -> int:
        """Discard up to n unread symbols without copying; returns the count
        actually skipped (O(1) cursor advance)."""
        rc = self._lib.ring_skip(self._handle, n)
        if rc < 0:
            _check(rc, "ring_skip")
        return rc

    def read_last(self, cp: int = 0, timeout: Optional[float] = None) -> np.ndarray:
        """readLastSymbol semantics (ShMemSymBuff.hpp:300-331): deliver the
        MOST RECENTLY written symbol and silently discard any older backlog
        (the reference GPU loop reads this way for every data symbol,
        gpuLS.cu:419-424).  Blocks only when the ring is empty."""
        return self._read(self._lib.ring_read_last, cp, False, timeout)

    def read_last_planar(self, cp: int = 0,
                         timeout: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
        out = self._read(self._lib.ring_read_last, cp, True, timeout)
        return out[0], out[1]

    def _read_i16(self, fn, cp: int, timeout: Optional[float]):
        if self.dtype != "sc16":
            raise RingError(f"{fn.__name__} requires an sc16 ring")
        keep = self.cols - cp
        out = np.empty((2, self.rows, keep), dtype=np.int16)
        p16 = ctypes.POINTER(ctypes.c_int16)
        rc = fn(self._handle, out[0].ctypes.data_as(p16),
                out[1].ctypes.data_as(p16), cp,
                (self._timeout if timeout is None else timeout))
        _check(rc, fn.__name__)
        return out[0], out[1]

    def read_next_planar_i16(self, cp: int = 0,
                             timeout: Optional[float] = None
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """sc16-native per-symbol read: (re, im) INT16 [rows, cols-cp], no
        float conversion -- the half-input-copy feed for the per-symbol
        consumer (whose jitted body widens sc16 on the device).  Mirrors the
        reference per-symbol loop moving the ring's native element type
        untouched (ShMemSymBuff_cucomplex.hpp:256-257,356-393)."""
        return self._read_i16(self._lib.ring_read_next_i16, cp, timeout)

    def read_last_planar_i16(self, cp: int = 0,
                             timeout: Optional[float] = None
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """readLastSymbol semantics, sc16-native: the freshest symbol as
        planar INT16, older backlog silently discarded."""
        return self._read_i16(self._lib.ring_read_last_i16, cp, timeout)

    # -- lifecycle / observability ----------------------------------------------
    @property
    def dropped(self) -> int:
        """Writer overruns recorded by the no-wait path."""
        return self._lib.ring_dropped(self._handle)

    @property
    def available(self) -> int:
        """Symbols currently buffered and unread."""
        return self._lib.ring_available(self._handle)

    @property
    def consumed(self) -> int:
        """Total symbols consumed from this ring so far (monotonic tail),
        including by readers that already exited.  With ``dropped`` this
        places a late-attaching reader on the writer-stream attempt cursor
        (consumed + dropped = attempt index of the next buffered symbol)."""
        return self._lib.ring_consumed(self._handle)

    @property
    def spin_seconds(self) -> float:
        """Cumulative time this end spent spin-waiting (read-phase analogue)."""
        return self._lib.ring_spin_seconds(self._handle)

    def info(self) -> str:
        """Human-readable segment summary (the reference's
        CSharedMemSimple::info(), CSharedMemSimple.hpp:133-137)."""
        return (f"SymbolRing(uid={self.uid!r}, {self.rows}x{self.cols}"
                f"x{self.length}, dtype={self.dtype}, "
                f"{'master' if self.master else 'slave'}, "
                f"available={self.available}, dropped={self.dropped}, "
                f"spin={self.spin_seconds:.3f}s)")

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Block until the reader consumed everything written (master-side
        teardown handshake).  Returns False on timeout; a shut-down ring
        counts as drained (the peer has exited)."""
        rc = self._lib.ring_wait_drained(self._handle, (self._timeout if timeout is None else timeout))
        if rc == RING_TIMEOUT:
            return False
        if rc == RING_SHUTDOWN:
            return True
        _check(rc, "ring_wait_drained")
        return True

    def shutdown(self) -> None:
        """Raise the size=-1 sentinel so peers unblock and exit."""
        self._lib.ring_shutdown(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.ring_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
