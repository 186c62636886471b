"""End-to-end three-process topology: tx_app -> rx_app -> demod_app.

Replicates the reference's runtime layout (SURVEY.md section 1): a TX
producing an IQ capture, an RX process PN-syncing it and writing symbols
into the shm ring as master, and a demod process draining the ring as slave
-- all via the CLI apps, checked for EVM against the sent data.
"""

import os
import subprocess
import sys
import uuid

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# Subprocesses run on the CPU backend with the repo importable.
_pp = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
ENV_BASE = {**os.environ, "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": os.pathsep.join([REPO] + _pp)}

A, F, CP, S = 4, 64, 8, 9


def run(cmd, **kw):
    return subprocess.run([sys.executable, "-m"] + cmd, cwd=REPO, env=ENV_BASE,
                          capture_output=True, text=True, timeout=300, **kw)


@pytest.fixture
def workdir(tmp_path):
    return tmp_path


@pytest.mark.parametrize("ring_dtype", ["complex64", "sc16"])
def test_three_process_loopback(workdir, ring_dtype):
    cap = str(workdir / "capture.dat")
    sent = str(workdir / "sent.dat")
    out = str(workdir / "Output_gpu.dat")
    uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
    common = ["--antennas", str(A), "--fft-size", str(F),
              "--cp-size", str(CP), "--frame-len", str(S)]
    ring_args = ["--ring-dtype", ring_dtype]

    # TX: modulate one frame through a 25 dB channel, with PN preamble.
    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap, "--data-out", sent,
             "--pn-preamble", "--snr", "35", "--channel-taps", "4",
             "--pilots", str(workdir / "nonexistent_pilots.dat"),
             "--pn-file", str(workdir / "nonexistent_pn.dat")] + common
            + ["--num-frames", "1"])
    assert r.returncode == 0, r.stderr

    # RX (master) and demod (slave) run concurrently.
    rx = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap,
         "--shm-uid", uid, "--thres", "0.05", "--wait-writes",
         "--pn-file", str(workdir / "nonexistent_pn.dat"),
         "--num-frames", "1"] + common + ring_args,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dm = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.demod_app",
         "--shm-uid", uid, "--output", out, "--num-frames", "1",
         "--pilots", str(workdir / "nonexistent_pilots.dat")] + common + ring_args,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    rx_out, rx_err = rx.communicate(timeout=300)
    dm_out, dm_err = dm.communicate(timeout=300)
    assert rx.returncode == 0, rx_err + rx_out
    assert dm.returncode == 0, dm_err + dm_out
    assert "PN sync" in rx_out

    got = np.fromfile(out, dtype=np.complex64).reshape(S - 1, F - 1)
    want = np.fromfile(sent, dtype=np.complex64).reshape(S - 1, F - 1)
    # demod output is ifftshift-ed (reference convention); undo for EVM.
    got_natural = np.fft.fftshift(got, axes=-1)
    evm = 10 * np.log10(np.mean(np.abs(got_natural - want) ** 2)
                        / np.mean(np.abs(want) ** 2))
    assert evm < -25.0, f"EVM {evm:.1f} dB"
    assert "ChanEst" in dm_out  # timing table printed

    # Sideband provenance index: one line per delivered frame with its
    # status, output row range, and writer-stream frame ordinal (clean
    # run -> all clean, contiguous, writer frame 0).
    idx_lines = open(out + ".index").read().splitlines()
    assert idx_lines == [f"0 clean 0 {S - 1} 0"]


def test_sc16_capture_file_roundtrip(workdir):
    """tx_app --out-format sc16 -> rx_app --file-format sc16: the int16 IQ
    capture path (USRP wire format) through PN sync and the ring."""
    cap = str(workdir / "capture_sc16.dat")
    sent = str(workdir / "sent.dat")
    out = str(workdir / "Output_gpu.dat")
    uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
    common = ["--antennas", str(A), "--fft-size", str(F),
              "--cp-size", str(CP), "--frame-len", str(S)]
    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap, "--data-out", sent,
             "--out-format", "sc16", "--pn-preamble", "--snr", "35",
             "--channel-taps", "4",
             "--pilots", str(workdir / "none.dat"),
             "--pn-file", str(workdir / "none.dat")] + common
            + ["--num-frames", "1"])
    assert r.returncode == 0, r.stderr
    assert np.fromfile(cap, dtype=np.int16).size > 0

    rx = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap,
         "--file-format", "sc16", "--shm-uid", uid, "--thres", "0.05",
         "--wait-writes", "--pn-file", str(workdir / "none.dat"),
         "--num-frames", "1"] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dm = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.demod_app",
         "--shm-uid", uid, "--output", out, "--num-frames", "1",
         "--pilots", str(workdir / "none.dat")] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    rx_out, rx_err = rx.communicate(timeout=300)
    dm_out, dm_err = dm.communicate(timeout=300)
    assert rx.returncode == 0, rx_err + rx_out
    assert dm.returncode == 0, dm_err + dm_out

    got = np.fromfile(out, dtype=np.complex64).reshape(S - 1, F - 1)
    want = np.fromfile(sent, dtype=np.complex64).reshape(S - 1, F - 1)
    got_natural = np.fft.fftshift(got, axes=-1)
    evm = 10 * np.log10(np.mean(np.abs(got_natural - want) ** 2)
                        / np.mean(np.abs(want) ** 2))
    assert evm < -25.0, f"EVM {evm:.1f} dB"


def test_continuous_rx_stops_on_reader_shutdown(workdir):
    """rx_app --num-frames 0 (live file-player mode) cycles the capture until
    the demod slave finishes and shuts the ring down; both exit cleanly."""
    cap = str(workdir / "capture.dat")
    out = str(workdir / "Output_gpu.dat")
    uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
    common = ["--antennas", str(A), "--fft-size", str(F),
              "--cp-size", str(CP), "--frame-len", str(S)]
    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap,
             "--pn-preamble", "--snr", "35", "--channel-taps", "4",
             "--pilots", str(workdir / "none.dat"),
             "--pn-file", str(workdir / "none.dat")] + common
            + ["--num-frames", "1"])
    assert r.returncode == 0, r.stderr

    rx = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap,
         "--shm-uid", uid, "--thres", "0.05", "--wait-writes",
         "--pn-file", str(workdir / "none.dat"),
         "--num-frames", "0"] + common,            # continuous
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dm = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.demod_app",
         "--shm-uid", uid, "--output", out, "--num-frames", "3",
         "--pilots", str(workdir / "none.dat")] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dm_out, dm_err = dm.communicate(timeout=300)
    rx_out, rx_err = rx.communicate(timeout=300)
    assert dm.returncode == 0, dm_err + dm_out
    assert rx.returncode == 0, rx_err + rx_out
    assert "demodulated 3 frame(s)" in dm_out
    assert "reader shut the ring down" in rx_out
    got = np.fromfile(out, dtype=np.complex64)
    assert got.size == 3 * (S - 1) * (F - 1)


def test_rx_app_no_peak_errors_cleanly(workdir):
    cap = str(workdir / "noise.dat")
    rng = np.random.default_rng(0)
    (0.001 * (rng.standard_normal((A, 4096)) + 1j * rng.standard_normal((A, 4096)))
     ).astype(np.complex64).tofile(cap)
    r = run(["ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap, "--thres", "0.9",
             "--antennas", str(A), "--fft-size", str(F), "--cp-size", str(CP),
             "--frame-len", str(S), "--shm-uid", f"/x{uuid.uuid4().hex[:8]}",
             "--pn-file", str(workdir / "none.dat")])
    assert r.returncode == 1
    assert "no PN peak" in r.stderr


def test_tx_app_requires_out():
    r = run(["ofdm_ls_mrc_tpu.apps.tx_app"])
    assert r.returncode == 2


def test_tx_app_in_file_uses_each_frames_data(workdir):
    """--in-file with multiple frames transmits frame k's data on frame k
    (not frame 0 repeated) and cycles when the file is short."""
    need = (S - 1) * (F - 1)
    rng = np.random.default_rng(5)
    payload = (rng.standard_normal(2 * need)
               + 1j * rng.standard_normal(2 * need)).astype(np.complex64)
    infile = str(workdir / "user_data.dat")
    payload.tofile(infile)
    sent = str(workdir / "sent.dat")
    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", str(workdir / "cap.dat"),
             "--in-file", infile, "--data-out", sent, "--num-frames", "3",
             "--antennas", str(A), "--fft-size", str(F), "--cp-size", str(CP),
             "--frame-len", str(S),
             "--pilots", str(workdir / "none.dat")])
    assert r.returncode == 0, r.stderr
    assert "cycling" in r.stderr          # 3 frames from a 2-frame file
    got = np.fromfile(sent, dtype=np.complex64)
    want = np.concatenate([payload, payload[:need]])   # frames 0, 1, 0
    np.testing.assert_array_equal(got, want)


def test_demod_app_mesh_divisibility_rejected(workdir):
    r = run(["ofdm_ls_mrc_tpu.apps.demod_app", "--mesh", "3x1",
             "--antennas", "16", "--fft-size", str(F), "--cp-size", "0",
             "--frame-len", str(S), "--shm-uid", "/nope",
             "--pilots", str(workdir / "none.dat")])
    assert r.returncode == 2 and "not divisible" in r.stderr


def test_rx_app_dumps_written_after_sigint_in_continuous_mode(workdir):
    """--dump-aligned/--dump-raw fire on EVERY exit path: continuous mode
    only leaves its loop via SIGINT/shutdown, and the reference dumps its
    captures after the stream stops (rx_and_corr.cpp:411-427)."""
    import signal as _signal
    import time as _time
    cap = str(workdir / "capture.dat")
    common = ["--antennas", str(A), "--fft-size", str(F),
              "--cp-size", str(CP), "--frame-len", str(S)]
    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap, "--pn-preamble",
             "--snr", "35", "--channel-taps", "4",
             "--pilots", str(workdir / "none.dat"),
             "--pn-file", str(workdir / "none.dat")] + common
            + ["--num-frames", "1"])
    assert r.returncode == 0, r.stderr
    uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
    rx = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap,
         "--shm-uid", uid, "--thres", "0.05",
         "--num-frames", "0", "--rate", "1e6", "--dump-aligned", "--dump-raw",
         "--file-prefix", str(workdir / "cdump"),
         "--pn-file", str(workdir / "none.dat")] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    # SIGINT only once streaming started (ring created): interrupting the
    # imports would be an unhandled KeyboardInterrupt, not the loop's.
    deadline = _time.monotonic() + 120
    while not os.path.exists("/dev/shm" + uid):
        assert rx.poll() is None and _time.monotonic() < deadline
        _time.sleep(0.1)
    _time.sleep(1.0)
    rx.send_signal(_signal.SIGINT)
    rx_out, rx_err = rx.communicate(timeout=120)
    assert rx.returncode == 0, rx_err + rx_out
    assert os.path.exists(str(workdir / "cdump_ch_0_binary")), rx_out
    assert os.path.exists(str(workdir / "cdump_raw_ch_0_binary"))


def test_rx_app_continuous_sync_rejects_dumps(workdir):
    r = run(["ofdm_ls_mrc_tpu.apps.rx_app", "--file", str(workdir / "x.dat"),
             "--continuous-sync", "--dump-raw",
             "--antennas", str(A), "--fft-size", str(F), "--cp-size", str(CP),
             "--frame-len", str(S), "--shm-uid", "/nope",
             "--pn-file", str(workdir / "none.dat")])
    assert r.returncode == 2 and "one-shot-sync" in r.stderr


def test_provenance_flags_rejected_outside_whole_frame_modes(workdir):
    """--drop-dirty lives in the whole-frame RingFeed; the per-symbol and
    distributed paths must fail loud instead of silently skipping the
    provenance guarantees.  (--frame-index IS supported per-symbol since
    r5 -- the per-symbol loop writes its own index.)"""
    common = ["--antennas", str(A), "--fft-size", str(F), "--cp-size", "0",
              "--frame-len", str(S), "--shm-uid", "/nope",
              "--pilots", str(workdir / "none.dat")]
    r = run(["ofdm_ls_mrc_tpu.apps.demod_app", "--per-symbol",
             "--drop-dirty"] + common)
    assert r.returncode == 2 and "whole-frame provenance" in r.stderr
    r = run(["ofdm_ls_mrc_tpu.apps.demod_app", "--distributed",
             "localhost:0", "--num-frames", "1", "--drop-dirty"] + common)
    assert r.returncode == 2 and "--distributed" in r.stderr


def test_per_symbol_mode_loopback(workdir):
    """--per-symbol: ring -> StreamingDemodulator -> output, one row per
    data symbol, with the per-slot read/chanest/decode table (the
    reference's per-symbol runtime loop, cpuLS_main.cpp:80-93)."""
    cap = str(workdir / "capture.dat")
    sent = str(workdir / "sent.dat")
    out = str(workdir / "Output_gpu.dat")
    uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
    common = ["--antennas", str(A), "--fft-size", str(F),
              "--cp-size", str(CP), "--frame-len", str(S)]

    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap, "--data-out", sent,
             "--pn-preamble", "--snr", "35", "--channel-taps", "4",
             "--pilots", str(workdir / "nonexistent_pilots.dat"),
             "--pn-file", str(workdir / "nonexistent_pn.dat")] + common
            + ["--num-frames", "2"])
    assert r.returncode == 0, r.stderr

    rx = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap,
         "--shm-uid", uid, "--thres", "0.05", "--wait-writes",
         "--pn-file", str(workdir / "nonexistent_pn.dat"),
         "--num-frames", "2"] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dm = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.demod_app",
         "--shm-uid", uid, "--output", out, "--num-frames", "2",
         "--per-symbol", "--link-quality", "qpsk",
         "--pilots", str(workdir / "nonexistent_pilots.dat")] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    rx_out, rx_err = rx.communicate(timeout=300)
    dm_out, dm_err = dm.communicate(timeout=300)
    assert rx.returncode == 0, rx_err + rx_out
    assert dm.returncode == 0, dm_err + dm_out
    assert "per-symbol" in dm_out

    got = np.fromfile(out, dtype=np.complex64).reshape(2 * (S - 1), F - 1)
    want = np.fromfile(sent, dtype=np.complex64).reshape(2 * (S - 1), F - 1)
    got_natural = np.fft.fftshift(got, axes=-1)
    evm = 10 * np.log10(np.mean(np.abs(got_natural - want) ** 2)
                        / np.mean(np.abs(want) ** 2))
    assert evm < -25.0, f"EVM {evm:.1f} dB"
    # The faithful per-slot table: read + chanest + decode avgs all nonzero.
    for row in ("Read:", "ChanEst:", "Decode:"):
        line = next(ln for ln in dm_out.splitlines() if ln.startswith(row))
        avg = float(line.replace(row, "").split()[0])
        assert avg > 0.0, f"{row} average is zero in:\n{dm_out}"

    # The live per-symbol loop is observable like the whole-frame mode
    # dd-EVM summary + a per-frame provenance index
    # with writer-frame mapping and the EVM column.
    assert "link quality (qpsk decision-directed EVM)" in dm_out
    idx = [ln.split() for ln in open(out + ".index").read().splitlines()]
    assert len(idx) == 2
    for i, ln in enumerate(idx):
        assert int(ln[0]) == i and ln[1] == "clean"
        assert (int(ln[2]), int(ln[3])) == (i * (S - 1), (i + 1) * (S - 1))
        assert int(ln[4]) == i                 # writer-stream frame ordinal
        assert float(ln[5]) < -20.0            # per-frame dd-EVM column


def test_per_symbol_sc16_native_loopback(workdir):
    """--per-symbol --sc16-native: planar INT16 symbols flow ring -> device
    per symbol (the sc16 wire format riding the low-latency path; the
    reference per-symbol loop consumes the ring's native element type,
    ShMemSymBuff_cucomplex.hpp:256-257,356-393).  EVM and the per-slot
    timing table must hold like the float per-symbol mode."""
    cap = str(workdir / "capture_sc16.dat")
    sent = str(workdir / "sent.dat")
    out = str(workdir / "Output_gpu.dat")
    uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
    common = ["--antennas", str(A), "--fft-size", str(F),
              "--cp-size", str(CP), "--frame-len", str(S)]

    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap, "--data-out", sent,
             "--out-format", "sc16", "--pn-preamble", "--snr", "35",
             "--channel-taps", "4",
             "--pilots", str(workdir / "nonexistent_pilots.dat"),
             "--pn-file", str(workdir / "nonexistent_pn.dat")] + common
            + ["--num-frames", "2"])
    assert r.returncode == 0, r.stderr

    rx = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap,
         "--file-format", "sc16", "--ring-dtype", "sc16", "--shm-uid", uid,
         "--thres", "0.05", "--wait-writes",
         "--pn-file", str(workdir / "nonexistent_pn.dat"),
         "--num-frames", "2"] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dm = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.demod_app",
         "--shm-uid", uid, "--output", out, "--num-frames", "2",
         "--per-symbol", "--ring-dtype", "sc16", "--sc16-native",
         "--pipeline", "composed",
         "--pilots", str(workdir / "nonexistent_pilots.dat")] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    rx_out, rx_err = rx.communicate(timeout=300)
    dm_out, dm_err = dm.communicate(timeout=300)
    assert rx.returncode == 0, rx_err + rx_out
    assert dm.returncode == 0, dm_err + dm_out
    assert "per-symbol" in dm_out

    got = np.fromfile(out, dtype=np.complex64).reshape(2 * (S - 1), F - 1)
    want = np.fromfile(sent, dtype=np.complex64).reshape(2 * (S - 1), F - 1)
    got_natural = np.fft.fftshift(got, axes=-1)
    evm = 10 * np.log10(np.mean(np.abs(got_natural - want) ** 2)
                        / np.mean(np.abs(want) ** 2))
    assert evm < -25.0, f"EVM {evm:.1f} dB"
    for row in ("Read:", "ChanEst:", "Decode:"):
        line = next(ln for ln in dm_out.splitlines() if ln.startswith(row))
        assert float(line.replace(row, "").split()[0]) > 0.0


def test_continuous_sync_recovers_from_sample_slip(workdir):
    """tx_app --pn-every-frame -> capture corrupted with inserted samples ->
    rx_app --continuous-sync re-syncs mid-stream -> demod EVM holds for all
    frames (the 'continuous re-sync loop' deliverable; reference
    receive loop rx_and_corr.cpp:305-405)."""
    cap = str(workdir / "capture.dat")
    sent = str(workdir / "sent.dat")
    out = str(workdir / "Output_gpu.dat")
    uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
    n_frames = 4
    common = ["--antennas", str(A), "--fft-size", str(F),
              "--cp-size", str(CP), "--frame-len", str(S)]

    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap, "--data-out", sent,
             "--pn-every-frame", "--snr", "35", "--channel-taps", "4",
             "--pilots", str(workdir / "nonexistent_pilots.dat"),
             "--pn-file", str(workdir / "nonexistent_pn.dat")] + common
            + ["--num-frames", str(n_frames)])
    assert r.returncode == 0, r.stderr

    # Insert a 11-sample slip between frame 1 and frame 2 (just before
    # frame 2's PN preamble) on every antenna.
    samples = np.fromfile(cap, dtype=np.complex64).reshape(A, -1)
    pn_len = 255
    frame_samps = S * (F + CP)
    cut = 2 * (pn_len + frame_samps)
    junk = (0.02 * (np.random.default_rng(5).standard_normal((A, 11))
                    + 1j * np.random.default_rng(6).standard_normal((A, 11)))
            ).astype(np.complex64)
    np.concatenate([samples[:, :cut], junk, samples[:, cut:]],
                   axis=1).tofile(cap)

    rx = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap,
         "--shm-uid", uid, "--thres", "0.4", "--wait-writes",
         "--continuous-sync", "--frame-size", "777",
         "--pn-file", str(workdir / "nonexistent_pn.dat"),
         "--num-frames", str(n_frames)] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dm = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.demod_app",
         "--shm-uid", uid, "--output", out, "--num-frames", str(n_frames),
         "--pilots", str(workdir / "nonexistent_pilots.dat")] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    rx_out, rx_err = rx.communicate(timeout=300)
    dm_out, dm_err = dm.communicate(timeout=300)
    assert rx.returncode == 0, rx_err + rx_out
    assert dm.returncode == 0, dm_err + dm_out
    assert "drift_corrections=1" in rx_out, rx_out

    got = np.fromfile(out, dtype=np.complex64).reshape(n_frames * (S - 1), F - 1)
    want = np.fromfile(sent, dtype=np.complex64).reshape(n_frames * (S - 1), F - 1)
    got_natural = np.fft.fftshift(got, axes=-1)
    # EVM per frame: ALL frames must survive the slip (it lands between
    # frames, absorbed as an in-window drift correction).
    for k in range(n_frames):
        sl = slice(k * (S - 1), (k + 1) * (S - 1))
        evm = 10 * np.log10(np.mean(np.abs(got_natural[sl] - want[sl]) ** 2)
                            / np.mean(np.abs(want[sl]) ** 2))
        assert evm < -25.0, f"frame {k}: EVM {evm:.1f} dB\n{rx_out}"


def test_multi_channel_cli_parity(workdir):
    """Per-channel rate/freq/gain parsing + channel-subset semantics + per-
    channel dumps (rx_and_corr.cpp:157-198,411-427)."""
    cap = str(workdir / "capture.dat")
    sent = str(workdir / "sent.dat")
    out = str(workdir / "Output_gpu.dat")
    uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
    common = ["--antennas", str(A), "--fft-size", str(F),
              "--cp-size", str(CP), "--frame-len", str(S)]

    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap, "--data-out", sent,
             "--pn-preamble", "--snr", "35", "--channel-taps", "4",
             "--channels", "0,1", "--freq", "2.4e9,2.41e9", "--gain", "10",
             "--pilots", str(workdir / "none.dat"),
             "--pn-file", str(workdir / "none.dat")] + common
            + ["--num-frames", "1"])
    assert r.returncode == 0, r.stderr
    assert "TX ch 0: rate=1.000 Msps freq=2400.000 MHz gain=10.0 dB" in r.stdout
    assert "TX ch 1: rate=1.000 Msps freq=2410.000 MHz gain=10.0 dB" in r.stdout

    # RX uses a 2-of-4 channel subset: the ring carries 2 antenna rows and
    # the demod runs 2-antenna MRC on exactly those rows.
    rx = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap,
         "--shm-uid", uid, "--thres", "0.05", "--wait-writes",
         "--channels", "1,3", "--gain", "5,7", "--dump-aligned",
         "--file-prefix", str(workdir / "dump"),
         "--pn-file", str(workdir / "none.dat"),
         "--num-frames", "1"] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dm = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.demod_app",
         "--shm-uid", uid, "--output", out, "--num-frames", "1",
         "--antennas", "2", "--fft-size", str(F), "--cp-size", str(CP),
         "--frame-len", str(S),
         "--pilots", str(workdir / "none.dat")],
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    rx_out, rx_err = rx.communicate(timeout=300)
    dm_out, dm_err = dm.communicate(timeout=300)
    assert rx.returncode == 0, rx_err + rx_out
    assert dm.returncode == 0, dm_err + dm_out
    assert "RX ch 1:" in rx_out and "gain=5.0 dB" in rx_out
    assert "RX ch 3:" in rx_out and "gain=7.0 dB" in rx_out
    assert "[2 x" in rx_out  # ring rows = selected channels

    # Per-channel dumps named by ORIGINAL channel id, only for the subset.
    assert os.path.exists(str(workdir / "dump_ch_1_binary"))
    assert os.path.exists(str(workdir / "dump_ch_3_binary"))
    assert not os.path.exists(str(workdir / "dump_ch_0_binary"))

    # 2-antenna MRC demod of the selected rows still recovers the data.
    got = np.fromfile(out, dtype=np.complex64).reshape(S - 1, F - 1)
    want = np.fromfile(sent, dtype=np.complex64).reshape(S - 1, F - 1)
    evm = 10 * np.log10(np.mean(np.abs(np.fft.fftshift(got, axes=-1) - want) ** 2)
                        / np.mean(np.abs(want) ** 2))
    assert evm < -20.0, f"EVM {evm:.1f} dB"

    # Bad per-channel value count is rejected loudly.
    r = run(["ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap, "--channels", "0,1",
             "--gain", "1,2,3", "--shm-uid", uid + "x"] + common)
    assert r.returncode != 0
    assert "--gain: 3 values for 2 channel(s)" in r.stderr


def test_downlink_app_zf_separation(workdir):
    """dl_app: multi-user ZF precode + modulate to a capture; --verify
    asserts inter-user interference is removed (cpuLS.hpp:415-463)."""
    out = str(workdir / "dl.dat")
    sent = str(workdir / "dl_sent.dat")
    r = run(["ofdm_ls_mrc_tpu.apps.dl_app", "--users", "3", "--antennas", "4",
             "--fft-size", str(F), "--cp-size", str(CP), "--frame-len", "4",
             "--out", out, "--data-out", sent, "--simulate-channel",
             "--verify"])
    assert r.returncode == 0, r.stderr + r.stdout
    assert "ZF separation EVM" in r.stdout
    cap = np.fromfile(out, dtype=np.complex64)
    assert cap.size == 4 * 3 * (F + CP)        # A x (S-1) x sym_len
    data = np.fromfile(sent, dtype=np.complex64)
    assert data.size == 3 * 3 * (F - 1)        # U x (S-1) x (F-1)
    # Modulated rows are max-abs normalized per row (modOneSymbol semantics).
    rows = np.fromfile(out, dtype=np.complex64).reshape(4, -1)
    assert np.max(np.abs(rows)) <= 1.0 + 1e-5


def test_downlink_app_channel_file_roundtrip(workdir):
    """--channel FILE path: explicit channel in, same separation result."""
    ch = str(workdir / "h.dat")
    out = str(workdir / "dl.dat")
    rng = np.random.default_rng(3)
    h = ((rng.standard_normal((F - 1, 2, 4))
          + 1j * rng.standard_normal((F - 1, 2, 4))) / np.sqrt(2)
         ).astype(np.complex64)
    h.tofile(ch)
    r = run(["ofdm_ls_mrc_tpu.apps.dl_app", "--users", "2", "--antennas", "4",
             "--fft-size", str(F), "--cp-size", str(CP), "--frame-len", "3",
             "--out", out, "--channel", ch, "--verify"])
    assert r.returncode == 0, r.stderr + r.stdout

    r = run(["ofdm_ls_mrc_tpu.apps.dl_app", "--users", "5", "--antennas", "4",
             "--fft-size", str(F), "--out", out, "--simulate-channel"])
    assert r.returncode != 0
    assert "U <= A" in r.stderr


def test_batch_frames_capture_mode(workdir):
    """--batch-frames N: one capture-scan dispatch per N frames, plus the
    per-frame flush of a short trailing batch; output matches the
    frame-by-frame path bit-for-bit."""
    cap = str(workdir / "capture.dat")
    sent = str(workdir / "sent.dat")
    out_b = str(workdir / "Output_batched.dat")
    out_f = str(workdir / "Output_frames.dat")
    n_frames = 5  # batch of 2 -> 2 full batches + 1 flushed frame
    common = ["--antennas", str(A), "--fft-size", str(F),
              "--cp-size", str(CP), "--frame-len", str(S)]
    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap, "--data-out", sent,
             "--pn-preamble", "--snr", "35", "--channel-taps", "4",
             "--pilots", str(workdir / "none.dat"),
             "--pn-file", str(workdir / "none.dat")] + common
            + ["--num-frames", str(n_frames)])
    assert r.returncode == 0, r.stderr

    for out, extra in ((out_b, ["--batch-frames", "2"]), (out_f, [])):
        uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
        rx = subprocess.Popen(
            [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file",
             cap, "--shm-uid", uid, "--thres", "0.05", "--wait-writes",
             "--pn-file", str(workdir / "none.dat"),
             "--num-frames", str(n_frames)] + common,
            cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        dm = subprocess.Popen(
            [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.demod_app",
             "--shm-uid", uid, "--output", out,
             "--num-frames", str(n_frames), "--no-timer",
             "--pilots", str(workdir / "none.dat")] + common + extra,
            cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        rx_out, rx_err = rx.communicate(timeout=300)
        dm_out, dm_err = dm.communicate(timeout=300)
        assert rx.returncode == 0, rx_err + rx_out
        assert dm.returncode == 0, dm_err + dm_out
        assert f"demodulated {n_frames} frame(s)" in dm_out

    got = np.fromfile(out_b, dtype=np.complex64)
    ref = np.fromfile(out_f, dtype=np.complex64)
    assert got.size == n_frames * (S - 1) * (F - 1)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_dump_symbols_debug_tap(workdir):
    """--dump-symbols appends every ring-read symbol as raw complex64 (the
    reference's Sym_copy_sh_mem.dat tap, ShMemSymBuff.hpp:355-362): the dump
    must equal the CP-stripped TX stream."""
    cap = str(workdir / "capture.dat")
    out = str(workdir / "Output_gpu.dat")
    dump = str(workdir / "sym_tap.dat")
    uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
    common = ["--antennas", str(A), "--fft-size", str(F),
              "--cp-size", str(CP), "--frame-len", str(S)]
    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap,
             "--pn-preamble", "--snr", "35", "--channel-taps", "4",
             "--pilots", str(workdir / "none.dat"),
             "--pn-file", str(workdir / "none.dat")] + common
            + ["--num-frames", "1"])
    assert r.returncode == 0, r.stderr

    rx = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap,
         "--shm-uid", uid, "--thres", "0.05", "--wait-writes",
         "--pn-file", str(workdir / "none.dat"), "--dump-aligned",
         "--file-prefix", str(workdir / "aligned"),
         "--num-frames", "1"] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dm = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.demod_app",
         "--shm-uid", uid, "--output", out, "--num-frames", "1",
         "--dump-symbols", dump,
         "--pilots", str(workdir / "none.dat")] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    rx_out, rx_err = rx.communicate(timeout=300)
    dm_out, dm_err = dm.communicate(timeout=300)
    assert rx.returncode == 0, rx_err + rx_out
    assert dm.returncode == 0, dm_err + dm_out

    tap = np.fromfile(dump, dtype=np.complex64).reshape(S, A, F)
    # The RX's aligned per-channel dump is the over-the-ring truth: strip
    # the CP and compare (ring drops CP on copy-out).
    ch0 = np.fromfile(str(workdir / "aligned_ch_0_binary"),
                      dtype=np.complex64).reshape(S, F + CP)
    np.testing.assert_allclose(tap[:, 0, :], ch0[:, CP:], rtol=1e-5, atol=1e-6)


def test_per_symbol_save_and_resume_state(workdir):
    """--save-state checkpoints the channel estimate per frame; --resume
    restores it on restart (app plumbing over io/state)."""
    cap = str(workdir / "capture.dat")
    out = str(workdir / "Output_gpu.dat")
    ckpt = str(workdir / "est.ckpt")
    common = ["--antennas", str(A), "--fft-size", str(F),
              "--cp-size", str(CP), "--frame-len", str(S)]
    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap,
             "--pn-preamble", "--snr", "35", "--channel-taps", "4",
             "--pilots", str(workdir / "none.dat"),
             "--pn-file", str(workdir / "none.dat")] + common
            + ["--num-frames", "1"])
    assert r.returncode == 0, r.stderr

    for phase in ("save", "resume"):
        uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
        rx = subprocess.Popen(
            [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file",
             cap, "--shm-uid", uid, "--thres", "0.05", "--wait-writes",
             "--pn-file", str(workdir / "none.dat"),
             "--num-frames", "1"] + common,
            cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        extra = (["--save-state", ckpt] if phase == "save"
                 else ["--resume", ckpt])
        dm = subprocess.Popen(
            [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.demod_app",
             "--shm-uid", uid, "--output", out, "--num-frames", "1",
             "--per-symbol", "--no-timer",
             "--pilots", str(workdir / "none.dat")] + common + extra,
            cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        rx_out, rx_err = rx.communicate(timeout=300)
        dm_out, dm_err = dm.communicate(timeout=300)
        assert rx.returncode == 0, rx_err + rx_out
        assert dm.returncode == 0, dm_err + dm_out
        if phase == "save":
            assert os.path.exists(ckpt)
        else:
            assert "resumed channel estimate" in dm_out


def test_sc16_native_feed_loopback(workdir):
    """--sc16-native: planar int16 flows ring -> host -> device and widens
    inside the jitted body; EVM matches the float path."""
    cap = str(workdir / "capture_sc16.dat")
    sent = str(workdir / "sent.dat")
    out = str(workdir / "Output_gpu.dat")
    uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
    # The reference FFT size, through the default (composed) body.
    common = ["--antennas", "2", "--fft-size", "1024",
              "--cp-size", str(CP), "--frame-len", "4"]
    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap, "--data-out", sent,
             "--out-format", "sc16", "--pn-preamble", "--snr", "35",
             "--channel-taps", "4",
             "--pilots", str(workdir / "none.dat"),
             "--pn-file", str(workdir / "none.dat")] + common
            + ["--num-frames", "1"])
    assert r.returncode == 0, r.stderr

    rx = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap,
         "--file-format", "sc16", "--ring-dtype", "sc16", "--shm-uid", uid,
         "--thres", "0.05", "--wait-writes",
         "--pn-file", str(workdir / "none.dat"),
         "--num-frames", "1"] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dm = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.demod_app",
         "--shm-uid", uid, "--output", out, "--num-frames", "1",
         "--ring-dtype", "sc16", "--sc16-native",
         "--pilots", str(workdir / "none.dat")] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    rx_out, rx_err = rx.communicate(timeout=600)
    dm_out, dm_err = dm.communicate(timeout=600)
    assert rx.returncode == 0, rx_err + rx_out
    assert dm.returncode == 0, dm_err + dm_out

    got = np.fromfile(out, dtype=np.complex64).reshape(3, 1023)
    want = np.fromfile(sent, dtype=np.complex64).reshape(3, 1023)
    got_natural = np.fft.fftshift(got, axes=-1)
    evm = 10 * np.log10(np.mean(np.abs(got_natural - want) ** 2)
                        / np.mean(np.abs(want) ** 2))
    assert evm < -25.0, f"EVM {evm:.1f} dB"

    # Misconfigurations are rejected loudly.
    r = run(["ofdm_ls_mrc_tpu.apps.demod_app", "--shm-uid", uid + "x",
             "--sc16-native"] + common)
    assert r.returncode == 2 and "requires --ring-dtype sc16" in r.stderr


def test_drop_dirty_excludes_frames_and_indexes_them(workdir, monkeypatch):
    """Sustained overrun -> best-effort frames are identifiable in the
    sideband index, and --drop-dirty keeps them out of the output file
    entirely (dirty frames must not land indistinguishably in
    the same stream as clean ones)."""
    from test_ring import _ScriptedRing

    from ofdm_ls_mrc_tpu.apps import demod_app
    from ofdm_ls_mrc_tpu.io import ring as ring_mod
    from ofdm_ls_mrc_tpu.io.feed import RingFeed

    fl = 3
    # Two clean frames, then a sustained-overrun tail (fresh drop delta on
    # every frame) long enough for two best-effort deliveries.
    stream = [(i, 0) for i in range(2 * fl)]
    stream += [(2 * fl + i, 1 + i // fl) for i in range(30)]
    scripted = _ScriptedRing(A, F, stream)

    class _FakeRing:
        rows, cols = A, F
        def __init__(self, *a, **kw):
            pass
        def close(self):
            pass
        def shutdown(self):
            pass

    monkeypatch.setattr(ring_mod, "SymbolRing", _FakeRing)
    monkeypatch.setattr(
        demod_app, "_make_feed",
        lambda ring, cfg, cp, timer, **kw: RingFeed(scripted, cfg))
    out = str(workdir / "Output_gpu.dat")
    rc = demod_app.main(
        ["--antennas", str(A), "--fft-size", str(F), "--cp-size", "0",
         "--frame-len", str(fl), "--num-frames", "4", "--drop-dirty",
         "--no-timer", "--output", out,
         "--pilots", str(workdir / "none.dat")])
    assert rc == 0
    rows = np.fromfile(out, dtype=np.complex64).reshape(-1, F - 1)
    assert rows.shape[0] == 2 * (fl - 1)          # only the clean frames
    statuses = [ln.split()[1]
                for ln in open(out + ".index").read().splitlines()]
    assert statuses == ["clean", "clean", "dropped-dirty", "dropped-dirty"]


def test_drop_dirty_index_order_under_batch_frames(workdir, monkeypatch):
    """--drop-dirty with --batch-frames > 1: the dropped-dirty index line
    keeps its DELIVERY position relative to clean frames pending in the
    batch (recording the drop eagerly would give it a lower seq than
    frames delivered before it)."""
    from test_ring import _ScriptedRing

    from ofdm_ls_mrc_tpu.apps import demod_app
    from ofdm_ls_mrc_tpu.io import ring as ring_mod
    from ofdm_ls_mrc_tpu.io.feed import RingFeed

    fl = 3
    # Delivery order: clean(f0), dirty(discarded frame then best-effort),
    # clean -- the dirty lands while f0 waits in the half-full batch.
    stream = ([(i, 0) for i in range(5)] + [(5, 1)]       # f0 clean; overrun
              + [(i, 1) for i in (6, 7, 8, 9)] + [(10, 2)]  # resync; dirty
              + [(i, 2) for i in range(11, 16)])            # resync; clean
    scripted = _ScriptedRing(A, F, stream)

    class _FakeRing:
        rows, cols = A, F
        def __init__(self, *a, **kw):
            pass
        def close(self):
            pass
        def shutdown(self):
            pass

    monkeypatch.setattr(ring_mod, "SymbolRing", _FakeRing)
    monkeypatch.setattr(
        demod_app, "_make_feed",
        lambda ring, cfg, cp, timer, **kw: RingFeed(scripted, cfg))
    out = str(workdir / "Output_gpu.dat")
    rc = demod_app.main(
        ["--antennas", str(A), "--fft-size", str(F), "--cp-size", "0",
         "--frame-len", str(fl), "--num-frames", "3", "--drop-dirty",
         "--batch-frames", "2", "--no-timer", "--output", out,
         "--pilots", str(workdir / "none.dat")])
    assert rc == 0
    rows = np.fromfile(out, dtype=np.complex64).reshape(-1, F - 1)
    assert rows.shape[0] == 2 * (fl - 1)          # only the clean frames
    lines = [ln.split() for ln in open(out + ".index").read().splitlines()]
    assert [ln[1] for ln in lines] == ["clean", "dropped-dirty", "clean"]
    assert [int(ln[0]) for ln in lines] == [0, 1, 2]   # delivery order
    # Emitted row ranges skip the dropped frame.
    assert [(int(ln[2]), int(ln[3])) for ln in lines] == [
        (0, fl - 1), (-1, -1), (fl - 1, 2 * (fl - 1))]


def test_per_symbol_one_deep_pipeline_order(workdir, monkeypatch):
    """The per-symbol loop must DISPATCH symbol k, READ symbol k+1, and
    only then consume k's output (the reference's per-symbol async-stream
    overlap, ShMemSymBuff_cucomplex.hpp:356-393)."""
    from ofdm_ls_mrc_tpu.apps import demod_app
    from ofdm_ls_mrc_tpu.io import ring as ring_mod
    from ofdm_ls_mrc_tpu.models import streaming as streaming_mod

    fl, rows, cols = 3, A, F
    events = []

    class _FakeRing:
        def __init__(self, *a, **kw):
            self._i = 0
        rows_, cols_ = rows, cols
        @property
        def consumed(self):
            return self._i
        def read_next_planar(self, cp=0):
            from ofdm_ls_mrc_tpu.io.ring import RingShutdown
            if self._i >= 2 * fl:
                raise RingShutdown("done")
            events.append(("read", self._i))
            self._i += 1
            z = np.zeros((rows, cols - cp), np.float32)
            return z, z
        def close(self):
            pass
        def shutdown(self):
            pass

    class _FakeOut:
        def __init__(self, slot):
            self._slot = slot
        @property
        def re(self):
            return np.zeros(F - 1, np.float32)
        def to_numpy(self):
            events.append(("consume", self._slot))
            return np.zeros((F - 1,), np.complex64)

    class _FakeSD:
        def __init__(self, *a, **kw):
            self.pipeline = "composed"
        def warmup(self, int16=False):
            pass
        def push_pilot(self, sym, slot=0):
            events.append(("pilot", slot))
        def push_symbol_async(self, sym, slot=1):
            events.append(("dispatch", slot))
            return _FakeOut(slot)

    monkeypatch.setattr(ring_mod, "SymbolRing", _FakeRing)
    monkeypatch.setattr(streaming_mod, "StreamingDemodulator", _FakeSD)
    out = str(workdir / "Output_gpu.dat")
    rc = demod_app.main(
        ["--antennas", str(rows), "--fft-size", str(cols), "--cp-size", "0",
         "--frame-len", str(fl), "--num-frames", "2", "--per-symbol",
         "--no-timer", "--output", out, "--pilots", str(workdir / "none.dat")])
    assert rc == 0
    # For every data symbol k (global read index r), the NEXT read happens
    # BEFORE k's consume -- the one-deep overlap window.
    for slot in (1, 2):
        d = events.index(("dispatch", slot))
        c = events.index(("consume", slot))
        reads_between = [e for e in events[d:c] if e[0] == "read"]
        assert reads_between, (
            f"slot {slot}: output consumed immediately after dispatch "
            f"(no overlapped read): {events}")


def test_distributed_rejects_malformed_local_devices(workdir):
    """--local-devices is parsed before jax.distributed starts: a bad list
    fails fast with a usage error instead of opening every card."""
    r = run(["ofdm_ls_mrc_tpu.apps.demod_app", "--distributed",
             "localhost:1", "--num-processes", "2", "--process-id", "0",
             "--local-devices", "0,x",
             "--pilots", str(workdir / "none.dat")])
    assert r.returncode == 2, r.stderr + r.stdout
    assert "--local-devices" in r.stderr


def test_sc16_native_rejects_fused_fallback(workdir, rng):
    """No fused pipeline and no fallback: the parser refuses the removed
    kernel's options, while sc16-native input needs no special FFT size --
    int16 planes at a 384-point FFT (no power-of-two split) widen in-jit
    and match the float path on the same quantized frame, on both bodies."""
    import jax.numpy as jnp

    from ofdm_ls_mrc_tpu import FrameConfig
    from ofdm_ls_mrc_tpu.models import UplinkReceiver
    from ofdm_ls_mrc_tpu.ops.cplx import CArray

    for bad in (["--pipeline", "fused"], ["--kernel-precision", "bf16"]):
        r = run(["ofdm_ls_mrc_tpu.apps.demod_app", "--shm-uid", "/unused",
                 "--ring-dtype", "sc16", "--sc16-native"] + bad)
        assert r.returncode == 2, r.stderr + r.stdout
        assert "invalid choice" in r.stderr or "unrecognized" in r.stderr

    cfg = FrameConfig(num_antennas=2, fft_size=384, cyclic_prefix=0,
                      frame_len=4)
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)
                   ).astype(np.complex64)
    q = rng.integers(-3000, 3000, size=(2, cfg.frame_len, 2, 384)
                     ).astype(np.int16)
    frame_q = (q[0].astype(np.float32) + 1j * q[1].astype(np.float32)
               ).astype(np.complex64) / 32767.0
    for pipeline in ("composed", "fast"):
        rx = UplinkReceiver(cfg, pilot, pipeline=pipeline)
        want = rx.demod_frame(frame_q).to_numpy()
        got = rx.demod_frame(CArray(jnp.asarray(q[0]),
                                    jnp.asarray(q[1]))).to_numpy()
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err < 1e-5, (pipeline, err)


def test_continuous_sync_file_player_exits_on_reader_shutdown(workdir):
    """--continuous-sync --num-frames 0: the producer must exit cleanly when
    the demod reader shuts the ring down, even with a full frame queue (the
    bounded-queue deadlock found in review)."""
    cap = str(workdir / "capture.dat")
    out = str(workdir / "Output_gpu.dat")
    uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
    common = ["--antennas", str(A), "--fft-size", str(F),
              "--cp-size", str(CP), "--frame-len", str(S)]
    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap,
             "--pn-every-frame", "--snr", "35", "--channel-taps", "4",
             "--pilots", str(workdir / "none.dat"),
             "--pn-file", str(workdir / "none.dat")] + common
            + ["--num-frames", "2"])
    assert r.returncode == 0, r.stderr

    rx = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap,
         "--shm-uid", uid, "--thres", "0.4", "--wait-writes",
         "--continuous-sync", "--frame-size", "700",
         "--pn-file", str(workdir / "none.dat"),
         "--num-frames", "0"] + common,                 # file-player mode
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dm = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.demod_app",
         "--shm-uid", uid, "--output", out, "--num-frames", "3",
         "--pilots", str(workdir / "none.dat")] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dm_out, dm_err = dm.communicate(timeout=300)
    rx_out, rx_err = rx.communicate(timeout=120)        # must NOT hang
    assert dm.returncode == 0, dm_err + dm_out
    assert rx.returncode == 0, rx_err + rx_out
    assert "demodulated 3 frame(s)" in dm_out
    assert "continuous sync:" in rx_out


@pytest.mark.parametrize("mesh,frame_len", [("2x1", 4), ("1x2", 5)])
def test_demod_app_sharded_mesh_sc16_native(workdir, mesh, frame_len):
    """--mesh + --sc16-native: int16 planes flow ring -> antenna-sharded
    mesh placement -> composed shard body (widens in-jit), end to end from
    the app surface on the virtual CPU mesh.  The 1x2 case covers a
    time-sharded mesh."""
    cap = str(workdir / "capture_sc16.dat")
    sent = str(workdir / "sent.dat")
    out = str(workdir / "Output_gpu.dat")
    uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
    common = ["--antennas", "2", "--fft-size", "1024",
              "--cp-size", str(CP), "--frame-len", str(frame_len)]
    env = {**ENV_BASE,
           "XLA_FLAGS": ENV_BASE.get("XLA_FLAGS", "")
           + " --xla_force_host_platform_device_count=2"}
    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap, "--data-out", sent,
             "--out-format", "sc16", "--pn-preamble", "--snr", "35",
             "--channel-taps", "4",
             "--pilots", str(workdir / "none.dat"),
             "--pn-file", str(workdir / "none.dat")] + common
            + ["--num-frames", "1"])
    assert r.returncode == 0, r.stderr

    rx = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap,
         "--file-format", "sc16", "--ring-dtype", "sc16", "--shm-uid", uid,
         "--thres", "0.05", "--wait-writes",
         "--pn-file", str(workdir / "none.dat"),
         "--num-frames", "1"] + common,
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dm = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.demod_app",
         "--shm-uid", uid, "--output", out, "--num-frames", "1",
         "--mesh", mesh, "--ring-dtype", "sc16", "--sc16-native",
         "--no-timer",
         "--pilots", str(workdir / "none.dat")] + common,
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    rx_out, rx_err = rx.communicate(timeout=600)
    dm_out, dm_err = dm.communicate(timeout=600)
    assert rx.returncode == 0, rx_err + rx_out
    assert dm.returncode == 0, dm_err + dm_out

    got = np.fromfile(out, dtype=np.complex64).reshape(frame_len - 1, 1023)
    want = np.fromfile(sent, dtype=np.complex64).reshape(frame_len - 1, 1023)
    evm = 10 * np.log10(np.mean(np.abs(np.fft.fftshift(got, axes=-1) - want) ** 2)
                        / np.mean(np.abs(want) ** 2))
    assert evm < -25.0, f"EVM {evm:.1f} dB"


def test_demod_app_sharded_mesh(workdir):
    """--mesh 2x2: the sharded receiver (antenna-sharded MRC + fused psum)
    reachable from the app surface, on the virtual CPU mesh."""
    cap = str(workdir / "capture.dat")
    sent = str(workdir / "sent.dat")
    out = str(workdir / "Output_gpu.dat")
    uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
    common = ["--antennas", str(A), "--fft-size", str(F),
              "--cp-size", str(CP), "--frame-len", str(S)]
    env = {**ENV_BASE,
           "XLA_FLAGS": ENV_BASE.get("XLA_FLAGS", "")
           + " --xla_force_host_platform_device_count=4"}
    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap, "--data-out", sent,
             "--pn-preamble", "--snr", "35", "--channel-taps", "4",
             "--pilots", str(workdir / "none.dat"),
             "--pn-file", str(workdir / "none.dat")] + common
            + ["--num-frames", "1"])
    assert r.returncode == 0, r.stderr

    rx = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap,
         "--shm-uid", uid, "--thres", "0.05", "--wait-writes",
         "--pn-file", str(workdir / "none.dat"),
         "--num-frames", "1"] + common,
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dm = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.demod_app",
         "--shm-uid", uid, "--output", out, "--num-frames", "1",
         "--mesh", "2x2", "--pipeline", "fast", "--no-timer",
         "--pilots", str(workdir / "none.dat")] + common,
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    rx_out, rx_err = rx.communicate(timeout=300)
    dm_out, dm_err = dm.communicate(timeout=300)
    assert rx.returncode == 0, rx_err + rx_out
    assert dm.returncode == 0, dm_err + dm_out

    got = np.fromfile(out, dtype=np.complex64).reshape(S - 1, F - 1)
    want = np.fromfile(sent, dtype=np.complex64).reshape(S - 1, F - 1)
    evm = 10 * np.log10(np.mean(np.abs(np.fft.fftshift(got, axes=-1) - want) ** 2)
                        / np.mean(np.abs(want) ** 2))
    assert evm < -25.0, f"EVM {evm:.1f} dB"


def test_per_symbol_sharded_mesh_loopback(workdir):
    """--per-symbol --mesh 2x1: the antenna-sharded streaming path
    (parallel/streaming.py) through the live three-process topology --
    estimate sharded per antenna shard, one 2*F-word psum per symbol."""
    cap = str(workdir / "capture.dat")
    sent = str(workdir / "sent.dat")
    out = str(workdir / "Output_gpu.dat")
    uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
    common = ["--antennas", str(A), "--fft-size", str(F),
              "--cp-size", str(CP), "--frame-len", str(S)]

    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap, "--data-out", sent,
             "--pn-preamble", "--snr", "35", "--channel-taps", "4",
             "--pilots", str(workdir / "nonexistent_pilots.dat"),
             "--pn-file", str(workdir / "nonexistent_pn.dat")] + common
            + ["--num-frames", "2"])
    assert r.returncode == 0, r.stderr

    rx = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap,
         "--shm-uid", uid, "--thres", "0.05", "--wait-writes",
         "--pn-file", str(workdir / "nonexistent_pn.dat"),
         "--num-frames", "2"] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dm = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.demod_app",
         "--shm-uid", uid, "--output", out, "--num-frames", "2",
         "--per-symbol", "--mesh", "2x1", "--pipeline", "fast",
         "--pilots", str(workdir / "nonexistent_pilots.dat")] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    rx_out, rx_err = rx.communicate(timeout=300)
    dm_out, dm_err = dm.communicate(timeout=300)
    assert rx.returncode == 0, rx_err + rx_out
    assert dm.returncode == 0, dm_err + dm_out

    got = np.fromfile(out, dtype=np.complex64).reshape(2 * (S - 1), F - 1)
    want = np.fromfile(sent, dtype=np.complex64).reshape(2 * (S - 1), F - 1)
    got_natural = np.fft.fftshift(got, axes=-1)
    evm = 10 * np.log10(np.mean(np.abs(got_natural - want) ** 2)
                        / np.mean(np.abs(want) ** 2))
    assert evm < -25.0, f"EVM {evm:.1f} dB"


def test_per_symbol_mesh_requires_ant_only(workdir):
    """--per-symbol with time shards is rejected up front: per-symbol
    streaming has no time batch to shard."""
    r = run(["ofdm_ls_mrc_tpu.apps.demod_app", "--per-symbol",
             "--mesh", "2x2", "--antennas", str(A), "--fft-size", str(F),
             "--cp-size", "0", "--frame-len", str(S), "--shm-uid", "/nope",
             "--pilots", str(workdir / "none.dat")])
    assert r.returncode == 2 and "ant axis only" in r.stderr


def test_link_quality_decision_directed_evm(workdir):
    """--link-quality: the live decision-directed EVM must track the true
    EVM (computed offline against the sent grid) at a low-SER operating
    point -- the operator metric needs no ground truth."""
    import re as _re
    cap = str(workdir / "capture.dat")
    sent = str(workdir / "sent.dat")
    out = str(workdir / "Output_gpu.dat")
    uid = f"/ofdm_app_{uuid.uuid4().hex[:8]}"
    common = ["--antennas", str(A), "--fft-size", str(F),
              "--cp-size", str(CP), "--frame-len", str(S)]

    r = run(["ofdm_ls_mrc_tpu.apps.tx_app", "--out", cap, "--data-out", sent,
             "--pn-preamble", "--snr", "35", "--channel-taps", "4",
             "--modulation", "16qam",
             "--pilots", str(workdir / "nonexistent_pilots.dat"),
             "--pn-file", str(workdir / "nonexistent_pn.dat")] + common
            + ["--num-frames", "2"])
    assert r.returncode == 0, r.stderr

    rx = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.rx_app", "--file", cap,
         "--shm-uid", uid, "--thres", "0.05", "--wait-writes",
         "--pn-file", str(workdir / "nonexistent_pn.dat"),
         "--num-frames", "2"] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dm = subprocess.Popen(
        [sys.executable, "-m", "ofdm_ls_mrc_tpu.apps.demod_app",
         "--shm-uid", uid, "--output", out, "--num-frames", "2",
         "--link-quality", "16qam", "--frame-index", out + ".index",
         "--pilots", str(workdir / "nonexistent_pilots.dat")] + common,
        cwd=REPO, env=ENV_BASE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    rx_out, rx_err = rx.communicate(timeout=300)
    dm_out, dm_err = dm.communicate(timeout=300)
    assert rx.returncode == 0, rx_err + rx_out
    assert dm.returncode == 0, dm_err + dm_out

    m = _re.search(r"link quality \(16qam decision-directed EVM\): "
                   r"(-?\d+\.\d) dB overall, worst block (-?\d+\.\d) dB "
                   r"over (\d+) block", dm_out)
    assert m, dm_out
    dd_evm, worst, blocks = float(m.group(1)), float(m.group(2)), int(m.group(3))
    assert blocks == 2

    got = np.fromfile(out, dtype=np.complex64).reshape(2 * (S - 1), F - 1)
    want = np.fromfile(sent, dtype=np.complex64).reshape(2 * (S - 1), F - 1)
    true_evm = 10 * np.log10(np.mean(np.abs(np.fft.fftshift(got, axes=-1)
                                            - want) ** 2)
                             / np.mean(np.abs(want) ** 2))
    assert true_evm < -25.0
    # At this operating point hard decisions are error-free, so dd == true.
    assert abs(dd_evm - true_evm) < 1.0, (dd_evm, true_evm)
    assert worst >= dd_evm - 0.01

    # Per-frame dd-EVM rides the provenance index as a sixth column, so a
    # degraded frame is locatable; both frames sit near the overall number.
    idx = [ln.split() for ln in open(out + ".index").read().splitlines()]
    assert len(idx) == 2 and all(len(p) == 6 for p in idx), idx
    per_frame = [float(p[5]) for p in idx]
    # The printed worst is rounded to one decimal; the index keeps two.
    assert max(per_frame) == pytest.approx(worst, abs=0.06)
    for v in per_frame:
        assert abs(v - dd_evm) < 1.5, (v, dd_evm)


def test_link_quality_unknown_scheme_rejected(workdir):
    # (--link-quality WORKS with --per-symbol since r5; only unknown
    # constellations are rejected.)
    r = run(["ofdm_ls_mrc_tpu.apps.demod_app", "--link-quality", "8psk",
             "--antennas", str(A), "--fft-size", str(F), "--cp-size", "0",
             "--frame-len", str(S), "--shm-uid", "/nope",
             "--pilots", str(workdir / "none.dat")])
    assert r.returncode == 2 and "unknown scheme" in r.stderr
