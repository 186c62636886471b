"""bench.py, chip_smoke.py and the device helpers they share: the parts that
run without a card -- refusing a non-GPU device, the cell and byte
accounting, and the trace reduction."""

import gzip
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

import bench  # noqa: E402

from ofdm_ls_mrc_tpu import FrameConfig  # noqa: E402

CPU_ENV = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}


def test_bench_refuses_cpu(capsys):
    with pytest.raises(SystemExit, match="refusing"):
        bench.main(["--batch", "1", "--reps", "1"])
    assert "device_us_per_frame" not in capsys.readouterr().out


@pytest.mark.parametrize("spec,want", [
    ("composed/sc16", [("composed", "sc16")]),
    ("composed/sc16,fast/f32", [("composed", "sc16"), ("fast", "f32")]),
])
def test_bench_parse_cells(spec, want):
    assert bench.parse_cells(spec) == want


@pytest.mark.parametrize("spec", ["fused/sc16", "composed/bf16", "composed"])
def test_bench_parse_cells_rejects(spec):
    with pytest.raises(SystemExit):
        bench.parse_cells(spec)


def test_bench_bytes_per_frame():
    """The reference frame: 16 x 1024 x 101 CP-free in, 100 x 1023 out."""
    cfg = FrameConfig(num_antennas=16, fft_size=1024, cyclic_prefix=0,
                      frame_len=101)
    out = 100 * 1023 * 8
    assert bench.bytes_per_frame(cfg, "sc16") == 101 * 16 * 1024 * 4 + out
    assert bench.bytes_per_frame(cfg, "f32") == 101 * 16 * 1024 * 8 + out
    assert bench.bytes_per_frame(cfg, "sc16") == 7_437_536


def test_bench_peaks_cover_h100():
    assert bench.PEAKS["NVIDIA H100 80GB HBM3"]["hbm_bytes_per_s"] == 3.35e12
    assert all("source" in p for p in bench.PEAKS.values())


@pytest.mark.parametrize("pipeline,inp", [("composed", "sc16"),
                                          ("fast", "f32")])
def test_bench_frames_harness(rng, pipeline, inp):
    """The R-loop harness itself (what the bench times) runs and returns a
    positive time and a compile time; on the CPU this is no device number."""
    cfg = FrameConfig(num_antennas=2, fft_size=64, cyclic_prefix=0,
                      frame_len=3)
    pilot = np.exp(2j * np.pi * rng.random(63)).astype(np.complex64)
    frames = bench.make_frames(cfg, 2, rng)
    t, compile_s = bench.bench_frames(cfg, pilot, frames, reps=1,
                                      pipeline=pipeline, input_dtype=inp,
                                      r_hi=3)
    assert t > 0 and compile_s >= 0


def test_require_gpu_refuses_cpu():
    from ofdm_ls_mrc_tpu.utils.device import describe, require_gpu

    assert describe()["platform"] == "cpu"
    with pytest.raises(SystemExit, match="refusing"):
        require_gpu("test")


def test_card_info_without_nvidia_smi(monkeypatch):
    from ofdm_ls_mrc_tpu.utils import device

    monkeypatch.setattr(device, "SMI_QUERY", ["/nonexistent/nvidia-smi"])
    assert device.card_info().startswith("unknown")


def test_chip_smoke_refuses_cpu(tmp_path):
    """No accelerator: non-zero exit and no result line."""
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, env=CPU_ENV, capture_output=True, text=True,
                       timeout=240)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "FAILED in phase device" in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py with nothing else of the repo beside it fails."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in CPU_ENV.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("multi", [False, True], ids=["one-card", "multi"])
def test_chip_smoke_rehearsal(multi):
    """The whole orchestration at a small geometry on the CPU (four virtual
    devices, four distributed processes for --multi): every phase passes,
    and a rehearsal still prints no result and exits 3."""
    cmd = [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--rehearse"]
    r = subprocess.run(cmd + (["--multi"] if multi else []), cwd=REPO,
                       env=CPU_ENV, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 3, r.stdout[-3000:] + r.stderr[-3000:]
    assert "all phases passed" in r.stdout
    assert '"ok"' not in r.stdout
    want = ("phase 7" if multi else "phase 5")
    assert want in r.stdout


def _write_trace(logdir, events):
    d = os.path.join(logdir, "plugins", "profile", "run1")
    os.makedirs(d)
    with gzip.open(os.path.join(d, "host.trace.json.gz"), "wt") as fh:
        json.dump({"traceEvents": events}, fh)


def test_summarize_trace_counts_gpu_tracks_only(tmp_path):
    """Device events are those on GPU device tracks ('/device:GPU:N');
    host threads are left out unless asked for."""
    from ofdm_ls_mrc_tpu.utils import profiling

    meta = [{"ph": "M", "name": "process_name", "pid": p, "args": {"name": n}}
            for p, n in ((1, "/device:GPU:0"), (2, "/host:CPU"),
                         (3, "/device:GPU:1 (stream)"))]
    evs = [{"ph": "X", "pid": 1, "name": "fusion", "dur": 30.0},
           {"ph": "X", "pid": 1, "name": "fusion", "dur": 10.0},
           {"ph": "X", "pid": 3, "name": "cufft", "dur": 5.0},
           {"ph": "X", "pid": 2, "name": "PjitFunction", "dur": 100.0}]
    _write_trace(str(tmp_path), meta + evs)
    dev = profiling.summarize_trace(str(tmp_path))
    assert list(dev) == ["fusion", "cufft"]
    assert dev["fusion"][1] == 2
    assert dev["fusion"][0] == pytest.approx(40e-6)
    every = profiling.summarize_trace(str(tmp_path), device_only=False)
    assert "PjitFunction" in every
