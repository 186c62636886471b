"""Real multi-process jax.distributed test: 2 'hosts' x 4 virtual devices.

The reference never scales compute past one box (SURVEY.md section 2: its
only inter-host transport is the radio link).  This test runs the
framework's actual multi-process story end to end: two OS processes
initialize jax.distributed against a local coordinator, build the
(ant, time) mesh with antennas inside each process and time-blocks across
processes, feed process-local data via ``global_from_host_blocks``
(jax.make_array_from_process_local_data), and each process checks its own
time-block against the NumPy golden.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_demod():
    port = _free_port()
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env_base["PYTHONPATH"] = REPO + os.pathsep + env_base.get("PYTHONPATH", "")
    procs = []
    for pid in range(2):
        env = dict(env_base, MH_COORD=f"127.0.0.1:{port}", MH_NPROC="2",
                   MH_PID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "_mh_worker.py")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert "rel err vs golden" in out


import pytest


def test_four_process_distributed_demod():
    """N=4 'hosts' x 2 devices each: the same worker legs (time-sharded,
    composed+psum at 1024, antenna-across-hosts whole-frame) at a process
    count where
    any hidden pairwise assumption (2-way splits, coordinator races) would
    break.  BASELINE metric 2 asks for N>=2; this is the N>2 evidence."""
    port = _free_port()
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env_base["PYTHONPATH"] = REPO + os.pathsep + env_base.get("PYTHONPATH", "")
    procs = []
    for pid in range(4):
        env = dict(env_base, MH_COORD=f"127.0.0.1:{port}", MH_NPROC="4",
                   MH_PID=str(pid), MH_LOCAL_DEVICES="2")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "_mh_worker.py")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=360)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert "antenna-sharded whole-frame rel err" in out


@pytest.mark.parametrize("fft,frame_len,extra",
                         [(64, 9, {}), (1024, 3, {}),
                          (1024, 3, {"DAPP_SC16": "1", "DAPP_CONT": "1"})],
                         ids=["presplit-64", "composed-1024",
                              "composed-sc16-continuous"])
def test_two_process_distributed_demod_app(tmp_path, fft, frame_len, extra):
    """The real demod_app CLI in --distributed mode: each process feeds its
    own ring with ITS antennas' symbols (antenna-across-hosts, BASELINE
    config 5) and process 0's output file matches the golden chain, at a
    64-point FFT and at the reference 1024-point FFT (f32 and sc16 rings,
    the latter with a continuous consumer)."""
    import uuid

    port = _free_port()
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env_base["PYTHONPATH"] = REPO + os.pathsep + env_base.get("PYTHONPATH", "")
    uid = f"/dapp_{uuid.uuid4().hex[:8]}"
    procs = []
    for pid in range(2):
        env = dict(env_base, MH_COORD=f"127.0.0.1:{port}", MH_NPROC="2",
                   MH_PID=str(pid), DAPP_UID=uid, DAPP_DIR=str(tmp_path),
                   DAPP_FFT=str(fft), DAPP_S=str(frame_len), **extra)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "_dapp_worker.py")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
    assert "app-distributed rel err vs golden" in outs[0]
    assert "merged index OK" in outs[0]
    assert "link quality (qpsk decision-directed EVM)" in outs[0]
    assert "link quality" not in outs[1]          # rank 0 owns the metric
