"""Smoke test for tools/soak.py: the packaged three-process sustained soak
(continuous rate-paced producer, catch-up consumer, provenance-indexed
per-frame EVM verdict) runs end to end on the CPU backend and passes."""

import json
import os
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_soak_smoke(tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    # --num-frames 3: the producer cycles three DISTINCT frames, so the
    # verdict also proves the writer-seq provenance mapping (every clean
    # block must score against its own sent grid, not just any grid).
    # --frames 4: the run ends after four delivered frames, however busy
    # the host (--seconds only caps it).
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "soak.py"),
         "--frames", "4", "--seconds", "150", "--min-frames", "2",
         "--num-frames", "3", "--dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=280)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["pass"] and rec["clean_frames"] >= 2
    assert rec["frames_target"] == 4
    assert rec["evm_clean_db"]["max"] <= -25.0
    assert rec["rx_rc"] == 0 and rec["demod_rc"] == 0


def test_soak_continuous_sync(tmp_path):
    """The producer leg runs the rolling receive loop (per-buffer PN
    correlate / cross-buffer stitch / re-acquire -- the reference
    rx_and_corr.cpp:305-405 shape) instead of one-shot sync, with a PN
    before every frame, and the verdict still holds."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "soak.py"),
         "--seconds", "8", "--min-frames", "2", "--num-frames", "1",
         "--continuous-sync", "--dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=280)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["pass"] and rec["clean_frames"] >= 2
    assert rec["sync"] == "continuous"
    assert rec["evm_clean_db"]["max"] <= -25.0
    # the producer-side rolling-sync summary is surfaced in the verdict
    assert rec["producer_sync"].startswith("continuous sync:")


def test_soak_per_symbol_consumer(tmp_path):
    """The consumer leg runs the reference's per-symbol runtime loop
    (firstVector + demodOneSymbol, cpuLS_main.cpp:80-93) against a
    BACKPRESSURED producer (writeNextSymbolWithWait semantics) and the
    verdict holds without a provenance index."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "soak.py"),
         "--seconds", "8", "--min-frames", "2", "--num-frames", "1",
         "--consumer", "per-symbol", "--dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=280)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["pass"] and rec["clean_frames"] >= 2
    assert rec["consumer"] == "per-symbol"
    assert rec["dirty_frames"] == 0          # backpressure: no overruns
    assert rec["evm_clean_db"]["max"] <= -25.0


def test_soak_per_symbol_sc16_native(tmp_path):
    """The per-symbol consumer rides the sc16 wire format end to end:
    planar INT16 per-symbol ring reads feed the composed body, which
    widens them in-jit."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "soak.py"),
         "--seconds", "8", "--min-frames", "2", "--num-frames", "1",
         "--consumer", "per-symbol", "--ring-dtype", "sc16",
         "--sc16-native", "--pipeline", "composed", "--dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=280)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["pass"] and rec["clean_frames"] >= 2
    assert rec["consumer"] == "per-symbol"
    assert rec["evm_clean_db"]["max"] <= -25.0


def test_soak_distributed(tmp_path):
    """The antenna-across-hosts topology under sustained pressure: the
    capture splits into two per-host antenna blocks with independent
    rate-paced producers, two demod_app --distributed consumers demodulate
    in LOCKSTEP (per-frame writer-seq agreement over jax.distributed), and
    every clean-indexed frame scores against its own sent grid (sustained
    multi-host operation).  Ends after four delivered frames, however busy
    the host."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "soak.py"),
         "--frames", "4", "--seconds", "150", "--min-frames", "2",
         "--num-frames", "3", "--distributed", "2", "--antennas", "8",
         "--dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=280)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["pass"] and rec["clean_frames"] >= 2
    assert rec["consumer"] == "distributed-2"
    assert rec["evm_clean_db"]["max"] <= -25.0
    assert rec["rx_rc"] == 0 and rec["demod_rc"] == 0


def test_soak_per_symbol_rejects_multi_frame():
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "soak.py"),
         "--consumer", "per-symbol", "--num-frames", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert r.returncode == 2
    assert "--num-frames 1" in r.stderr


def test_soak_continuous_sync_rejects_multi_frame():
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "soak.py"),
         "--continuous-sync", "--num-frames", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert r.returncode == 2
    assert "--num-frames 1" in r.stderr


def test_soak_per_symbol_sharded_mesh(tmp_path):
    """The per-symbol consumer on an ANTx1 mesh: the antenna-sharded
    streaming demodulator (parallel/streaming.py) under the same
    backpressured-producer verdict -- the low-latency path soaked
    through the live topology."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        flags = (flags + " --xla_force_host_platform_device_count=2").strip()
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": flags}
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "soak.py"),
         "--seconds", "8", "--min-frames", "2", "--num-frames", "1",
         "--consumer", "per-symbol", "--mesh", "2x1", "--pipeline", "fast",
         "--dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=280)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["pass"] and rec["clean_frames"] >= 2
    # (No dirty_frames assertion: per-symbol mode has no provenance index,
    # so that counter is structurally 0 -- the EVM bound below is the real
    # misalignment check, since a shifted frame decodes to noise.)
    assert rec["evm_clean_db"]["max"] <= -25.0


def test_soak_per_symbol_mesh_requires_ant_only():
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "soak.py"),
         "--consumer", "per-symbol", "--num-frames", "1", "--mesh", "2x2"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert r.returncode == 2
    assert "ant axis only" in r.stderr
