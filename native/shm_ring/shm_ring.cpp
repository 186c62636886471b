// shm_ring: POSIX shared-memory symbol ring buffer.
//
// Re-design of the reference's IPC transport (C1+C2/C3/C4):
// CSharedMemSimple.hpp (shm_open/ftruncate/mmap wrapper) plus the
// ShMemSymBuff ring protocol (ShMemSymBuff.hpp:193-484): a fixed ring of
// `len` symbol matrices, a producer (SDR ingest process, ring *master*) and
// a consumer (demod process, *slave*), lock-free spin-waiting, with the
// reference's `size == -1` shutdown handshake (ShMemSymBuff.hpp:221-230).
//
// Protocol re-design (semantics preserved, defects removed):
//  * The reference tracks wrapping read/write cursors in plain ints, which
//    (a) is a data race and (b) conflates "full" with "empty" -- its reader
//    must stay one slot behind the writer (spin on `writePtr == p`,
//    ShMemSymBuff.hpp:271) adding a one-symbol latency bubble, and its
//    empty-start needs a `writePtr == -1` sentinel.  Here head/tail are
//    monotonically increasing 64-bit atomics with acquire/release ordering:
//    empty == (head == tail), full == (head - tail == len).  No sentinel,
//    no stay-one-behind bubble, no race.
//  * Every spin loop takes a deadline; -ETIMEDOUT instead of hanging forever
//    (the reference slave ctor spins forever, ShMemSymBuff.hpp:213-216).
//  * The no-wait write path (writeNextSymbolNoWait, ShMemSymBuff.hpp:460-482,
//    used by the live RX) drops the NEW symbol on overrun and counts it,
//    instead of silently overwriting the slot the reader may be copying.
//  * The read path can deinterleave (re,im) into planar float32 planes and
//    drop the cyclic prefix during the copy-out (ShMemSymBuff.hpp:281-294),
//    producing the exact layout the device feed wants with zero extra passes.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 shm_ring.cpp -o libshm_ring.so -lrt -pthread

#include <atomic>
#include <cerrno>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <new>
#include <string>
#include <thread>
#include <type_traits>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

using Clock = std::chrono::steady_clock;

constexpr int32_t kMagic = 0x52494E47;  // "RING"

// Element formats (the reference's ShMemSymBuff_cucomplex.hpp templates the
// ring on element type; here it is a runtime header field).
enum : int32_t {
  FMT_CF32 = 0,   // interleaved complex64 (2 x float32)
  FMT_SC16 = 1,   // interleaved complex int16 (USRP "sc16" wire format)
};

struct RingHeader {
  int32_t magic;
  int32_t rows;         // antennas
  int32_t cols;         // samples per row INCLUDING cyclic prefix
  int32_t len;          // number of symbol slots (lenOfBuffer)
  int32_t fmt;          // FMT_* element format
  int32_t pad_;
  std::atomic<int32_t> size;      // len when live; -1 = shutdown sentinel
  std::atomic<int32_t> dropped;   // overrun counter (no-wait writer)
  std::atomic<int64_t> head;      // symbols written (monotonic)
  std::atomic<int64_t> tail;      // symbols consumed (monotonic)
};
static_assert(std::is_standard_layout<RingHeader>::value, "shm layout");
static_assert(sizeof(std::atomic<int32_t>) == sizeof(int32_t) &&
              sizeof(std::atomic<int64_t>) == sizeof(int64_t),
              "atomics must be layout-compatible for shm");

struct Ring {
  RingHeader* hdr = nullptr;
  char* data = nullptr;       // len * rows*cols*2 elements of fmt's scalar
  size_t map_bytes = 0;
  std::string uid;
  bool master = false;
  int64_t spin_ns = 0;        // accumulated wait time (observability)
};

inline size_t elem_bytes(int32_t fmt) {
  return fmt == FMT_SC16 ? sizeof(int16_t) : sizeof(float);
}

inline size_t slot_scalars(const RingHeader* h) {
  return static_cast<size_t>(h->rows) * h->cols * 2;
}

inline size_t slot_bytes(const RingHeader* h) {
  return slot_scalars(h) * elem_bytes(h->fmt);
}

inline char* slot_ptr(Ring* r, int64_t seq) {
  return r->data + slot_bytes(r->hdr) * (seq % r->hdr->len);
}

enum : int {
  RING_OK = 0,
  RING_TIMEOUT = -1,
  RING_SHUTDOWN = -2,
  RING_BADARG = -3,
  RING_OVERRUN = -4,
};

// Spin until pred() or deadline/shutdown; RING_OK on success.
template <typename Pred>
int spin_until(Ring* r, Pred pred, double timeout_s) {
  if (pred()) return RING_OK;
  auto t0 = Clock::now();
  auto deadline = t0 + std::chrono::duration_cast<Clock::duration>(
                           std::chrono::duration<double>(timeout_s));
  int iters = 0;
  for (;;) {
    if (pred()) break;
    if (r->hdr->size.load(std::memory_order_acquire) == -1) return RING_SHUTDOWN;
    if (Clock::now() >= deadline) return RING_TIMEOUT;
    if (++iters > 64) std::this_thread::yield();
  }
  r->spin_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
                    Clock::now() - t0).count();
  return RING_OK;
}

}  // namespace

extern "C" {

// Create (master) or attach to (slave) a named ring.  Slave blocks up to
// timeout_s for the master to initialize.  fmt: 0 = complex64, 1 = sc16
// (interleaved int16 IQ, the USRP wire format -- half the shm bandwidth).
// Returns nullptr on failure.
void* ring_open_fmt(const char* uid, int rows, int cols, int len, int master,
                    double timeout_s, int fmt) {
  if (!uid || rows <= 0 || cols <= 0 || len <= 1) return nullptr;
  if (fmt != FMT_CF32 && fmt != FMT_SC16) return nullptr;
  size_t bytes = sizeof(RingHeader) +
                 elem_bytes(fmt) * static_cast<size_t>(rows) * cols * 2 * len;

  // Only the master creates and sizes the segment.  A slave must never
  // ftruncate: with mismatched geometry/format its computed size could
  // SHRINK the live segment under the master's mapping (SIGBUS on the next
  // producer write).  The slave attaches to whatever exists -- retrying
  // until the master has created it -- and validates against the header.
  int fd = -1;
  if (master) {
    // Fresh inode ALWAYS: a segment left by a crashed producer still holds
    // a published header (size > 0), so re-initializing it in place would
    // let a concurrently-attaching slave pass the size>0 acquire gate on
    // the STALE value and race the non-atomic geometry rewrite.  Unlinking
    // first gives this master a brand-new zero-filled segment; any slave
    // still mapped to the old inode times out cleanly.
    fd = shm_open(uid, O_CREAT | O_EXCL | O_RDWR, S_IRUSR | S_IWUSR);
    if (fd < 0 && errno == EEXIST) {
      shm_unlink(uid);
      fd = shm_open(uid, O_CREAT | O_EXCL | O_RDWR, S_IRUSR | S_IWUSR);
    }
    if (fd < 0) return nullptr;
    if (ftruncate(fd, static_cast<off_t>(bytes)) != 0) {
      close(fd);
      return nullptr;
    }
  } else {
    auto deadline = Clock::now() + std::chrono::duration_cast<Clock::duration>(
                                       std::chrono::duration<double>(timeout_s));
    for (;;) {
      fd = shm_open(uid, O_RDWR, 0);
      if (fd >= 0) {
        struct stat st;
        if (fstat(fd, &st) == 0 &&
            static_cast<size_t>(st.st_size) >= bytes) {
          break;  // master created and sized it (it truncates before init)
        }
        close(fd);
        fd = -1;
      }
      if (Clock::now() >= deadline) return nullptr;
      std::this_thread::yield();
    }
  }
  void* mem = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;

  Ring* r = new (std::nothrow) Ring();
  if (!r) {
    munmap(mem, bytes);
    return nullptr;
  }
  r->hdr = static_cast<RingHeader*>(mem);
  r->data = static_cast<char*>(mem) + sizeof(RingHeader);
  r->map_bytes = bytes;
  r->uid = uid;
  r->master = master != 0;

  if (r->master) {
    r->hdr->magic = kMagic;
    r->hdr->rows = rows;
    r->hdr->cols = cols;
    r->hdr->len = len;
    r->hdr->fmt = fmt;
    r->hdr->dropped.store(0, std::memory_order_relaxed);
    r->hdr->head.store(0, std::memory_order_relaxed);
    r->hdr->tail.store(0, std::memory_order_relaxed);
    r->hdr->size.store(len, std::memory_order_release);  // publishes init
  } else {
    auto deadline = Clock::now() + std::chrono::duration_cast<Clock::duration>(
                                       std::chrono::duration<double>(timeout_s));
    while (r->hdr->size.load(std::memory_order_acquire) <= 0 ||
           r->hdr->magic != kMagic) {
      if (Clock::now() >= deadline) {
        munmap(mem, bytes);
        delete r;
        return nullptr;
      }
      std::this_thread::yield();
    }
    if (r->hdr->rows != rows || r->hdr->cols != cols || r->hdr->len != len ||
        r->hdr->fmt != fmt) {
      munmap(mem, bytes);
      delete r;
      return nullptr;
    }
  }
  return r;
}

// Back-compat entry: complex64 element format.
void* ring_open(const char* uid, int rows, int cols, int len, int master,
                double timeout_s) {
  return ring_open_fmt(uid, rows, cols, len, master, timeout_s, FMT_CF32);
}

// Shutdown handshake + unmap.  EITHER side raises the size=-1 sentinel so a
// peer blocked in a spin loop observes the exit immediately (RingShutdown)
// instead of burning its full timeout (the reference's destructor dance,
// ShMemSymBuff.hpp:221-230); the master additionally unlinks the segment.
void ring_close(void* ring) {
  Ring* r = static_cast<Ring*>(ring);
  if (!r) return;
  r->hdr->size.store(-1, std::memory_order_release);
  if (r->master) {
    shm_unlink(r->uid.c_str());
  }
  munmap(r->hdr, r->map_bytes);
  delete r;
}

// Mark the ring shut down without closing the mapping (either side).
void ring_shutdown(void* ring) {
  Ring* r = static_cast<Ring*>(ring);
  if (r) r->hdr->size.store(-1, std::memory_order_release);
}

// Accessors guard the handle like every other entry point: a NULL from a
// closed Python-side ring must surface as a 0/-error, not a segfault.
int ring_rows(void* ring) {
  return ring ? static_cast<Ring*>(ring)->hdr->rows : RING_BADARG;
}
int ring_cols(void* ring) {
  return ring ? static_cast<Ring*>(ring)->hdr->cols : RING_BADARG;
}
int ring_len(void* ring) {
  return ring ? static_cast<Ring*>(ring)->hdr->len : RING_BADARG;
}
int ring_dropped(void* ring) {
  if (!ring) return 0;
  return static_cast<Ring*>(ring)->hdr->dropped.load(std::memory_order_relaxed);
}
// Total symbols consumed from this ring so far (monotonic tail) -- by ANY
// reader, including ones that exited.  With `dropped`, this locates a
// late-attaching reader on the writer's attempt cursor:
// consumed + dropped = attempt index of the next buffered symbol.
int64_t ring_consumed(void* ring) {
  if (!ring) return 0;
  return static_cast<Ring*>(ring)->hdr->tail.load(std::memory_order_acquire);
}
// Symbols currently buffered and unread.
int ring_available(void* ring) {
  if (!ring) return 0;
  RingHeader* h = static_cast<Ring*>(ring)->hdr;
  return static_cast<int>(h->head.load(std::memory_order_acquire) -
                          h->tail.load(std::memory_order_acquire));
}
double ring_spin_seconds(void* ring) {
  if (!ring) return 0.0;
  return static_cast<Ring*>(ring)->spin_ns * 1e-9;
}

// Write one symbol (rows*cols interleaved complex64 floats).
// wait=1: writeNextSymbolWithWait semantics -- backpressure on the reader
// (ShMemSymBuff.hpp:429-458).  wait=0: writeNextSymbolNoWait (live RX path,
// ShMemSymBuff.hpp:460-482) -- never blocks; on overrun the new symbol is
// dropped and counted.
static int write_impl(Ring* r, const void* sym, int wait, double timeout_s,
                      int32_t src_fmt) {
  if (!r || !sym) return RING_BADARG;
  RingHeader* h = r->hdr;
  if (src_fmt != h->fmt) return RING_BADARG;
  if (h->size.load(std::memory_order_acquire) == -1) return RING_SHUTDOWN;

  int64_t head = h->head.load(std::memory_order_relaxed);
  auto space = [&] {
    return head - h->tail.load(std::memory_order_acquire) < h->len;
  };
  if (wait) {
    int rc = spin_until(r, space, timeout_s);
    if (rc != RING_OK) return rc;
  } else if (!space()) {
    h->dropped.fetch_add(1, std::memory_order_relaxed);
    return RING_OVERRUN;
  }

  std::memcpy(slot_ptr(r, head), sym, slot_bytes(h));
  h->head.store(head + 1, std::memory_order_release);
  return RING_OK;
}

int ring_write(void* ring, const float* sym, int wait, double timeout_s) {
  return write_impl(static_cast<Ring*>(ring), sym, wait, timeout_s, FMT_CF32);
}

// sc16 writer: interleaved int16 IQ straight off an SDR stream.
int ring_write_sc16(void* ring, const int16_t* sym, int wait, double timeout_s) {
  return write_impl(static_cast<Ring*>(ring), sym, wait, timeout_s, FMT_SC16);
}

// Batch write: n contiguous slot-sized symbols from one buffer -- the
// producer analogue of ring_read_frame.  An ingest process extracts many
// symbols per radio recv buffer; writing them in ONE native call removes
// the per-symbol foreign-call overhead, which outweighs the memcpy of one
// symbol at the reference geometry.
//
// Returns the number of symbols written (>= 0) or a negative error.
//   wait != 0: blocks per slot; success means the full n landed.  On
//              timeout/shutdown the already-written prefix stays in the
//              ring (head counts it) and the error is returned.
//   wait == 0: never blocks; full-ring symbols are dropped and counted
//              (writeNextSymbolNoWait semantics, per symbol).
static int write_batch_impl(Ring* r, const char* syms, int n, int wait,
                            double timeout_s, int32_t src_fmt) {
  if (!r || !syms || n <= 0) return RING_BADARG;
  const size_t sb = slot_bytes(r->hdr);
  int written = 0;
  for (int k = 0; k < n; ++k) {
    int rc = write_impl(r, syms + sb * k, wait, timeout_s, src_fmt);
    if (rc == RING_OK) {
      ++written;
    } else if (!wait && rc == RING_OVERRUN) {
      continue;  // dropped + counted by write_impl
    } else {
      return rc;  // timeout, shutdown, badarg
    }
  }
  return written;
}

int ring_write_batch(void* ring, const float* syms, int n, int wait,
                     double timeout_s) {
  return write_batch_impl(static_cast<Ring*>(ring),
                          reinterpret_cast<const char*>(syms), n, wait,
                          timeout_s, FMT_CF32);
}

int ring_write_batch_sc16(void* ring, const int16_t* syms, int n, int wait,
                          double timeout_s) {
  return write_batch_impl(static_cast<Ring*>(ring),
                          reinterpret_cast<const char*>(syms), n, wait,
                          timeout_s, FMT_SC16);
}

namespace {

// Copy slot -> out (always float32 on the way out).  Interleaved elements in
// shm; output either interleaved (planar=0: [rows][cols-cp]*2 floats) or
// planar float32 (planar=1: re[rows][cols-cp] then im[rows][cols-cp]).  CP
// dropped on the fly (the read-side prefix drop of ShMemSymBuff.hpp:281-294);
// sc16 slots convert to float with the UHD full-scale factor 1/32767 during
// the same pass, so the int16 path costs no extra sweep.
constexpr float kSc16Scale = 1.0f / 32767.0f;

void copy_out_split(Ring* r, int64_t seq, float* re, float* im, int cp);

void copy_out(Ring* r, int64_t seq, float* out, int cp, int planar) {
  RingHeader* h = r->hdr;
  const int rows = h->rows, cols = h->cols;
  const int keep = cols - cp;
  const bool sc16 = h->fmt == FMT_SC16;
  const char* base = slot_ptr(r, seq);

  auto row_src_f32 = [&](int i) {
    return reinterpret_cast<const float*>(base) +
           (static_cast<size_t>(i) * cols + cp) * 2;
  };
  auto row_src_s16 = [&](int i) {
    return reinterpret_cast<const int16_t*>(base) +
           (static_cast<size_t>(i) * cols + cp) * 2;
  };

  if (!planar) {
    for (int i = 0; i < rows; ++i) {
      float* dst = out + static_cast<size_t>(i) * keep * 2;
      if (!sc16) {
        std::memcpy(dst, row_src_f32(i), sizeof(float) * keep * 2);
      } else {
        const int16_t* row = row_src_s16(i);
        for (int j = 0; j < 2 * keep; ++j) dst[j] = row[j] * kSc16Scale;
      }
    }
  } else {
    // One definition of the planar deinterleave: the split-destination
    // copy with the im plane placed right after the re plane.
    copy_out_split(r, seq, out, out + static_cast<size_t>(rows) * keep, cp);
  }
}

// Split-destination planar copy: re/im planes go to independent buffers
// (the batch frame read fills [n][rows][keep] re and im frame planes).
void copy_out_split(Ring* r, int64_t seq, float* re, float* im, int cp) {
  RingHeader* h = r->hdr;
  const int rows = h->rows, cols = h->cols;
  const int keep = cols - cp;
  const bool sc16 = h->fmt == FMT_SC16;
  const char* base = slot_ptr(r, seq);
  for (int i = 0; i < rows; ++i) {
    float* rre = re + static_cast<size_t>(i) * keep;
    float* rim = im + static_cast<size_t>(i) * keep;
    if (!sc16) {
      const float* row = reinterpret_cast<const float*>(base) +
                         (static_cast<size_t>(i) * cols + cp) * 2;
      for (int j = 0; j < keep; ++j) {
        rre[j] = row[2 * j];
        rim[j] = row[2 * j + 1];
      }
    } else {
      const int16_t* row = reinterpret_cast<const int16_t*>(base) +
                           (static_cast<size_t>(i) * cols + cp) * 2;
      for (int j = 0; j < keep; ++j) {
        rre[j] = row[2 * j] * kSc16Scale;
        rim[j] = row[2 * j + 1] * kSc16Scale;
      }
    }
  }
}

int read_impl(void* ring, float* out, int cp, int planar, double timeout_s) {
  Ring* r = static_cast<Ring*>(ring);
  if (!r || !out) return RING_BADARG;
  RingHeader* h = r->hdr;
  if (cp < 0 || cp >= h->cols) return RING_BADARG;

  int64_t tail = h->tail.load(std::memory_order_relaxed);
  int rc = spin_until(r, [&] {
    return h->head.load(std::memory_order_acquire) > tail;
  }, timeout_s);
  if (rc != RING_OK) return rc;

  copy_out(r, tail, out, cp, planar);
  h->tail.store(tail + 1, std::memory_order_release);
  return RING_OK;
}

}  // namespace

// Block until the reader has consumed everything written (used by the
// master before teardown, replacing the reference's destructor handshake,
// ShMemSymBuff.hpp:221-230).  RING_OK once drained.
int ring_wait_drained(void* ring, double timeout_s) {
  Ring* r = static_cast<Ring*>(ring);
  if (!r) return RING_BADARG;
  RingHeader* h = r->hdr;
  return spin_until(r, [&] {
    return h->tail.load(std::memory_order_acquire) >=
           h->head.load(std::memory_order_acquire);
  }, timeout_s);
}

// Blocking read of the next symbol (readNextSymbol, ShMemSymBuff.hpp:237-297).
int ring_read_next(void* ring, float* out, int cp, int planar, double timeout_s) {
  return read_impl(ring, out, cp, planar, timeout_s);
}

// Batch read: n consecutive symbols into planar frame planes
// re/im [n][rows][cols-cp], spin-waiting per symbol natively -- one library
// call per frame instead of per symbol (the whole-frame analogue of the
// reference's per-symbol readNextSymbol loop, cpuLS_main.cpp:83-92).
//
// Returns RING_OK on a full frame.  A TIMEOUT that interrupts a partially
// read frame returns the count already consumed (0 < k < n): the tail has
// irreversibly advanced k symbols INTO a frame, so a caller that would
// retry must know the stream is no longer frame-aligned (write_batch's
// partial-prefix note, mirrored).  Shutdown always returns RING_SHUTDOWN
// (the stream is over; the partial frame is moot).
int ring_read_frame(void* ring, float* re, float* im, int n, int cp,
                    double timeout_s) {
  Ring* r = static_cast<Ring*>(ring);
  if (!r || !re || !im || n <= 0) return RING_BADARG;
  RingHeader* h = r->hdr;
  if (cp < 0 || cp >= h->cols) return RING_BADARG;
  const size_t plane = static_cast<size_t>(h->rows) * (h->cols - cp);

  for (int k = 0; k < n; ++k) {
    int64_t tail = h->tail.load(std::memory_order_relaxed);
    int rc = spin_until(r, [&] {
      return h->head.load(std::memory_order_acquire) > tail;
    }, timeout_s);
    if (rc == RING_TIMEOUT && k > 0) return k;
    if (rc != RING_OK) return rc;
    copy_out_split(r, tail, re + plane * k, im + plane * k, cp);
    h->tail.store(tail + 1, std::memory_order_release);
  }
  return RING_OK;
}

// Deinterleave one sc16 slot into planar int16 planes (no float convert),
// CP dropped on the fly.  Shared by the batch and per-symbol i16 reads.
static void copy_out_split_i16(Ring* r, int64_t seq, int16_t* re, int16_t* im,
                               int cp) {
  RingHeader* h = r->hdr;
  const int rows = h->rows, cols = h->cols;
  const int keep = cols - cp;
  const char* base = slot_ptr(r, seq);
  for (int i = 0; i < rows; ++i) {
    const int16_t* row = reinterpret_cast<const int16_t*>(base) +
                         (static_cast<size_t>(i) * cols + cp) * 2;
    int16_t* rre = re + static_cast<size_t>(i) * keep;
    int16_t* rim = im + static_cast<size_t>(i) * keep;
    for (int j = 0; j < keep; ++j) {
      rre[j] = row[2 * j];
      rim[j] = row[2 * j + 1];
    }
  }
}

// sc16-native batch read: n consecutive symbols deinterleaved into planar
// int16 planes WITHOUT the float conversion -- the zero-copy-fidelity feed
// for device programs that widen sc16 on the device (half the host and
// H2D bytes of the float path).  Only valid on FMT_SC16 rings.
int ring_read_frame_i16(void* ring, int16_t* re, int16_t* im, int n, int cp,
                        double timeout_s) {
  Ring* r = static_cast<Ring*>(ring);
  if (!r || !re || !im || n <= 0) return RING_BADARG;
  RingHeader* h = r->hdr;
  if (h->fmt != FMT_SC16) return RING_BADARG;
  if (cp < 0 || cp >= h->cols) return RING_BADARG;
  const size_t plane = static_cast<size_t>(h->rows) * (h->cols - cp);

  for (int k = 0; k < n; ++k) {
    int64_t tail = h->tail.load(std::memory_order_relaxed);
    int rc = spin_until(r, [&] {
      return h->head.load(std::memory_order_acquire) > tail;
    }, timeout_s);
    if (rc == RING_TIMEOUT && k > 0) return k;  // mid-frame: see ring_read_frame
    if (rc != RING_OK) return rc;
    copy_out_split_i16(r, tail, re + plane * k, im + plane * k, cp);
    h->tail.store(tail + 1, std::memory_order_release);
  }
  return RING_OK;
}

// sc16-native per-symbol read: the int16 twin of ring_read_next's planar
// form -- one symbol deinterleaved into planar int16 planes with CP dropped,
// no float conversion.  The per-symbol low-latency consumer feeds the fused
// kernel int16 planes directly (half the per-dispatch input DMA of the f32
// path; the reference per-symbol loop likewise moves the ring's native
// element type untouched, ShMemSymBuff_cucomplex.hpp:256-257,356-393).
int ring_read_next_i16(void* ring, int16_t* re, int16_t* im, int cp,
                       double timeout_s) {
  Ring* r = static_cast<Ring*>(ring);
  if (!r || !re || !im) return RING_BADARG;
  RingHeader* h = r->hdr;
  if (h->fmt != FMT_SC16) return RING_BADARG;
  if (cp < 0 || cp >= h->cols) return RING_BADARG;

  int64_t tail = h->tail.load(std::memory_order_relaxed);
  int rc = spin_until(r, [&] {
    return h->head.load(std::memory_order_acquire) > tail;
  }, timeout_s);
  if (rc != RING_OK) return rc;

  copy_out_split_i16(r, tail, re, im, cp);
  h->tail.store(tail + 1, std::memory_order_release);
  return RING_OK;
}

// sc16-native readLastSymbol (ShMemSymBuff.hpp:300-331 semantics): claim
// everything up to head, deinterleave only the freshest slot as int16.
int ring_read_last_i16(void* ring, int16_t* re, int16_t* im, int cp,
                       double timeout_s) {
  Ring* r = static_cast<Ring*>(ring);
  if (!r || !re || !im) return RING_BADARG;
  RingHeader* h = r->hdr;
  if (h->fmt != FMT_SC16) return RING_BADARG;
  if (cp < 0 || cp >= h->cols) return RING_BADARG;

  int rc = spin_until(r, [&] {
    return h->head.load(std::memory_order_acquire) >
           h->tail.load(std::memory_order_relaxed);
  }, timeout_s);
  if (rc != RING_OK) return rc;

  int64_t head = h->head.load(std::memory_order_acquire);
  copy_out_split_i16(r, head - 1, re, im, cp);
  h->tail.store(head, std::memory_order_release);
  return RING_OK;
}

// Discard up to n unread symbols without copying (O(1) cursor advance);
// returns how many were skipped.  The cheap backlog drop for real-time
// catch-up consumers (frame-aligned skipping lives in io/feed.py).
int ring_skip(void* ring, int n) {
  Ring* r = static_cast<Ring*>(ring);
  if (!r || n < 0) return RING_BADARG;
  RingHeader* h = r->hdr;
  int64_t tail = h->tail.load(std::memory_order_relaxed);
  int64_t avail = h->head.load(std::memory_order_acquire) - tail;
  int64_t skip = avail < n ? avail : n;
  if (skip > 0) h->tail.store(tail + skip, std::memory_order_release);
  return static_cast<int>(skip);
}

// readLastSymbol (ShMemSymBuff.hpp:300-331): real-time consumers read the
// MOST RECENTLY written symbol, silently discarding any backlog (the
// reference GPU per-symbol loop uses this for every data symbol after the
// first, gpuLS.cu:419-424).  Blocks only when the ring is empty.
int ring_read_last(void* ring, float* out, int cp, int planar, double timeout_s) {
  Ring* r = static_cast<Ring*>(ring);
  if (!r || !out) return RING_BADARG;
  RingHeader* h = r->hdr;
  if (cp < 0 || cp >= h->cols) return RING_BADARG;

  int rc = spin_until(r, [&] {
    return h->head.load(std::memory_order_acquire) >
           h->tail.load(std::memory_order_relaxed);
  }, timeout_s);
  if (rc != RING_OK) return rc;

  // Single consumer: claim everything up to head, copy the freshest slot.
  int64_t head = h->head.load(std::memory_order_acquire);
  copy_out(r, head - 1, out, cp, planar);
  h->tail.store(head, std::memory_order_release);
  return RING_OK;
}

}  // extern "C"
