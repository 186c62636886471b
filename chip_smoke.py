"""Smoke test of the uplink receiver on NVIDIA GPUs: one card, or four.

Phases with no arguments (one card):
  1. device    JAX's devices, platform, device kind, count and XLA_FLAGS,
               and the card's name and power limit from nvidia-smi.  Fails
               unless the platform is ``gpu``: nothing falls back to the CPU.
  2. native    builds native/ (shm ring, golden DSP, PN sync) from source on
               this host, so no library compiled elsewhere is reused.
  3. numerics  UplinkReceiver at 16x1024x101 (CP 72, and CP 0 with sc16
               input), the fast body, StreamingDemodulator per symbol and
               ShardedUplinkReceiver on a 1x1 mesh, through a 25 dB 16-tap
               channel, against golden/dsp.py (relative max error <= 5e-5,
               EVM < -30 dB); compiled.memory_analysis() of the frame step;
               then the repo's ``gpu``-marked tests.
  4. main path tx_app -> rx_app --file (ring master, kept on the CPU) ->
               demod_app (the only process on the card) -> compare_app
               against the NumPy golden of the symbols demod_app read, for
               the f32 ring, the sc16 --sc16-native ring and --per-symbol.
               Every frame must be written and score under the EVM bound.
  5. bench     bench.py's default cell plus the composed/f32 and fast cells.

With --multi (four cards), only what exists across cards:
  6. mesh         demod_app --mesh 4x1 at 64x1024x101 against single-card
                  demod_app on the same capture and against the golden; the
                  sharded step holds exactly one fused all-reduce.
  7. distributed  demod_app --distributed: four processes on one host, one
                  card each (--local-devices), antenna block i on process i.

Only one process uses a card at a time: this parent imports no JAX, each
phase that needs the card runs in a child process, one after another, and
the ring producer and file tools run with JAX_PLATFORMS=cpu.  The last line
of standard output is ``{"ok": true, "device": {...}}``, printed only when
every phase passed; any failure exits non-zero without it.

Run:  python chip_smoke.py            # one GPU
      python chip_smoke.py --multi    # four GPUs of one host
      python chip_smoke.py --rehearse [--multi]   # small CPU dry run of the
                                      # orchestration; never prints a result
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import uuid

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".chip_smoke")
DEADLINE_S = 1150.0          # the whole run must end within 1200 s

REL_ERR_MAX = 5e-5           # vs golden/dsp.py, fp32-grade
EVM_MAX_DB = -30.0           # 25 dB per antenna plus the array's MRC gain
GOLDEN_EVM_MAX_DB = -70.0    # compare_app: demod_app output vs the golden

# (antennas, fft, cp, frame_len, frames): the reference geometry, and the
# small one a CPU rehearsal uses.
FULL = dict(antennas=16, fft=1024, cp=72, frame_len=101, frames=20)
SMALL = dict(antennas=16, fft=64, cp=16, frame_len=9, frames=3)
MULTI_ANTENNAS = 64          # BASELINE config 4
MULTI_FRAMES = 4


class PhaseFailed(Exception):
    pass


# ---------------------------------------------------------------------------
# Parent side: no JAX here.
# ---------------------------------------------------------------------------

class Runner:
    def __init__(self, rehearse: bool):
        self.rehearse = rehearse
        self.t0 = time.perf_counter()
        self.procs = []
        pp = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
              if p]
        self.env = {**os.environ, "PYTHONPATH": os.pathsep.join([REPO] + pp)}
        self.cpu_env = {**self.env, "JAX_PLATFORMS": "cpu"}
        # The card's process: JAX's default backend on the machine with the
        # card; a rehearsal stays on the CPU, with four virtual devices for
        # the 4x1 mesh.
        self.dev_env = dict(self.env)
        if rehearse:
            self.dev_env.update(
                JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")

    def remaining(self, cap: float) -> float:
        left = DEADLINE_S - (time.perf_counter() - self.t0)
        if left <= 5:
            raise PhaseFailed("out of time before the phase started")
        return min(cap, left)

    def run(self, name, cmd, env, timeout, echo=True):
        """Run a child to completion; a nonzero or signal exit fails."""
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                               text=True, timeout=self.remaining(timeout))
        except subprocess.TimeoutExpired as e:
            raise PhaseFailed(f"{name}: timed out after {e.timeout:.0f} s")
        if echo:
            for line in r.stdout.splitlines():
                print(f"  [{name}] {line}")
        print(f"  [{name}] exit {r.returncode} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if r.returncode != 0:
            tail = (r.stderr or "")[-3000:]
            raise PhaseFailed(f"{name}: exit {r.returncode}"
                              + (" (killed by a signal)" if r.returncode < 0
                                 else "") + f"\n{tail}")
        return r

    def spawn(self, name, cmd, env):
        log = open(os.path.join(WORK, f"{name}.log"), "w+")
        p = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                             stderr=subprocess.STDOUT, text=True)
        p._log, p._name = log, name
        self.procs.append(p)
        return p

    def finish(self, procs, timeout):
        """Wait for every process; any nonzero or signal exit fails."""
        deadline = time.perf_counter() + self.remaining(timeout)
        # Poll all of them: once one fails or time is up, the rest (a ring
        # master blocked on a dead reader, say) are killed, not waited for.
        while any(p.poll() is None for p in procs):
            if (time.perf_counter() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                break
            time.sleep(0.2)
        failed = []
        for p in procs:
            p._log.seek(0)
            text = p._log.read()
            p._log.close()
            tail = [ln for ln in text.splitlines() if ln.strip()][-6:]
            for line in tail:
                print(f"  [{p._name}] {line}")
            print(f"  [{p._name}] exit {p.returncode}", flush=True)
            if p.returncode != 0:
                failed.append(f"{p._name}: exit {p.returncode}"
                              + (" (killed by a signal)"
                                 if p.returncode < 0 else "")
                              + "\n" + text[-3000:])
        if failed:
            raise PhaseFailed("\n".join(failed))

    def stop_all(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def module(self, mod, *args):
        return [sys.executable, "-m", f"ofdm_ls_mrc_tpu.apps.{mod}",
                *map(str, args)]

    def child(self, phase, *args):
        return [sys.executable, os.path.abspath(__file__), "--phase", phase,
                *map(str, args)]


def geom_args(g, antennas=None):
    return ["--antennas", antennas or g["antennas"], "--fft-size", g["fft"],
            "--cp-size", g["cp"], "--frame-len", g["frame_len"]]


def phase_device(r: Runner) -> dict:
    out = r.run("device", r.child("device") + (["--rehearse"]
                                               if r.rehearse else []),
                r.dev_env, 180)
    from ofdm_ls_mrc_tpu.utils.device import card_info
    print(f"  [device] nvidia-smi name, power.limit: {card_info()}")
    dev = json.loads(out.stdout.strip().splitlines()[-1].split(" ", 1)[1])
    return dev


def phase_native(r: Runner):
    # -B: rebuild even when the copy of the tree carries libraries built
    # elsewhere (-march=native).  A rehearsal keeps the local build: other
    # processes on this host may have those libraries loaded.
    force = [] if r.rehearse else ["-B"]
    r.run("native", ["make", *force, "-C", os.path.join(REPO, "native")],
          r.env, 300, echo=False)


def make_capture(r: Runner, g, name, fmt, antennas=None, frames=None):
    """tx_app: PN preamble + frames through a 30 dB 16-tap channel."""
    cap = os.path.join(WORK, f"{name}.dat")
    sent = os.path.join(WORK, f"{name}_sent.dat")
    r.run(f"tx_app {name}", r.module(
        "tx_app", "--out", cap, "--data-out", sent, "--out-format", fmt,
        "--pn-preamble", "--snr", 30, "--channel-taps", min(16, g["cp"]),
        "--modulation", "16qam", "--num-frames", frames or g["frames"],
        "--pilots", os.path.join(WORK, "pilots.dat"),
        "--pn-file", os.path.join(WORK, "pn.dat"), "--seed", 7,
        *geom_args(g, antennas)), r.cpu_env, 300, echo=False)
    return cap, sent


def serve(r: Runner, g, tag, cap, ring_dtype, demod_extra, antennas=None,
          frames=None, n_rings=1):
    """rx_app --file (ring master on the CPU) + demod_app (the card)."""
    frames = frames or g["frames"]
    uid = f"/smoke_{uuid.uuid4().hex[:8]}"
    out = os.path.join(WORK, f"{tag}_out.dat")
    dump = os.path.join(WORK, f"{tag}_dump.dat")
    ring = ["--ring-dtype", ring_dtype]
    fmt = ["--file-format", "sc16"] if ring_dtype == "sc16" else []
    rx = r.spawn(f"rx_app {tag}", r.module(
        "rx_app", "--file", cap, "--shm-uid", uid, "--thres", 0.05,
        "--wait-writes", "--num-frames", frames, "--timeout", 300,
        "--pn-file", os.path.join(WORK, "pn.dat"), *fmt, *ring,
        *geom_args(g, antennas)), r.cpu_env)
    dm = r.spawn(f"demod_app {tag}", r.module(
        "demod_app", "--shm-uid", uid, "--output", out, "--num-frames",
        frames, "--timeout", 300, "--pilots", os.path.join(WORK, "pilots.dat"),
        "--dump-symbols", dump, *ring, *demod_extra,
        *geom_args(g, antennas)), r.dev_env)
    r.finish([dm, rx], 420)
    return out, dump


def score(r: Runner, g, tag, out, dumps, sent, antennas=None, frames=None):
    """Golden of the symbols demod_app read, frame count and per-frame EVM
    (CPU child), then compare_app output vs golden."""
    gold = os.path.join(WORK, f"{tag}_golden.dat")
    r.run(f"score {tag}", r.child(
        "golden", "--out", out, "--gold", gold, "--sent", sent,
        "--antennas", antennas or g["antennas"], "--fft", g["fft"],
        "--frame-len", g["frame_len"], "--frames", frames or g["frames"],
        "--dumps", ",".join(dumps)), r.cpu_env, 300)
    r.run(f"compare_app {tag}", r.module(
        "compare_app", gold, out, "--subcarriers", g["fft"] - 1,
        "--threshold-db", GOLDEN_EVM_MAX_DB), r.cpu_env, 120)


def phase_main_path(r: Runner, g):
    from ofdm_ls_mrc_tpu.golden.io import write_pilot
    import numpy as np

    rng = np.random.default_rng(11)
    write_pilot(os.path.join(WORK, "pilots.dat"),
                np.exp(2j * np.pi * rng.random(g["fft"] - 1)
                       ).astype(np.complex64))
    cap32, sent32 = make_capture(r, g, "cap_f32", "cf32")
    cap16, sent16 = make_capture(r, g, "cap_sc16", "sc16")
    for tag, cap, sent, ring, extra in (
            ("f32", cap32, sent32, "complex64", []),
            ("sc16", cap16, sent16, "sc16", ["--sc16-native"]),
            ("per-symbol", cap16, sent16, "sc16",
             ["--sc16-native", "--per-symbol"])):
        out, dump = serve(r, g, tag, cap, ring, extra)
        score(r, g, tag, out, [dump], sent)


def phase_bench(r: Runner):
    cmd = [sys.executable, os.path.join(REPO, "bench.py"), "--cells",
           "composed/sc16,composed/f32,fast/sc16,fast/f32"]
    if r.rehearse:
        # The bench measures a GPU only: on the CPU it must refuse.
        p = subprocess.run(cmd, cwd=REPO, env=r.cpu_env, capture_output=True,
                           text=True, timeout=r.remaining(120))
        if p.returncode == 0 or "refusing" not in p.stderr:
            raise PhaseFailed("bench.py ran on the CPU instead of refusing")
        print("  [bench] refused the CPU, as it must")
        return
    out = r.run("bench", cmd, r.dev_env, 400)
    recs = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]
    if len(recs) != 4:
        raise PhaseFailed(f"bench: {len(recs)} cells reported, expected 4")


def phase_gpu_tests(r: Runner):
    env = dict(r.dev_env)
    if not r.rehearse:
        env["JAX_PLATFORMS"] = "cuda"
    out = r.run("gpu tests", [sys.executable, "-m", "pytest", "-m", "gpu",
                              "-q", "-rs", "-p", "no:cacheprovider",
                              os.path.join(REPO, "tests")], env, 400)
    summary = out.stdout.strip().splitlines()[-1]
    if "passed" not in summary and not r.rehearse:
        raise PhaseFailed(f"gpu tests: nothing passed ({summary})")
    if "skipped" in summary and not r.rehearse:
        raise PhaseFailed(f"gpu tests: skipped on the card ({summary})")


def phase_mesh(r: Runner, g):
    """demod_app --mesh 4x1 vs single-card demod_app on one capture."""
    from ofdm_ls_mrc_tpu.golden.io import write_pilot
    import numpy as np

    a = MULTI_ANTENNAS
    rng = np.random.default_rng(13)
    write_pilot(os.path.join(WORK, "pilots.dat"),
                np.exp(2j * np.pi * rng.random(g["fft"] - 1)
                       ).astype(np.complex64))
    r.run("mesh numerics", r.child(
        "multi-numerics", "--antennas", a, "--fft", g["fft"],
        "--cp", g["cp"], "--frame-len", g["frame_len"])
        + (["--rehearse"] if r.rehearse else []), r.dev_env, 400)
    cap, sent = make_capture(r, g, "cap_multi", "cf32", antennas=a,
                             frames=MULTI_FRAMES)
    out_mesh, dump = serve(r, g, "mesh4x1", cap, "complex64",
                           ["--mesh", "4x1", "--no-timer"], antennas=a,
                           frames=MULTI_FRAMES)
    score(r, g, "mesh4x1", out_mesh, [dump], sent, antennas=a,
          frames=MULTI_FRAMES)
    out_one, _ = serve(r, g, "single", cap, "complex64", ["--no-timer"],
                       antennas=a, frames=MULTI_FRAMES)
    r.run("mesh vs single", r.child("agree", out_mesh, out_one, g["fft"]),
          r.cpu_env, 120)
    return cap, sent


def phase_distributed(r: Runner, g, cap, sent, nproc=4):
    """Four demod_app --distributed processes, one card each; process i
    reads antenna block i from its own ring."""
    import numpy as np

    a = MULTI_ANTENNAS
    a_local = a // nproc
    rows = np.fromfile(cap, dtype=np.complex64).reshape(a, -1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(WORK, "dist_out.dat")
    rxs, dms, dumps = [], [], []
    for i in range(nproc):
        host_cap = os.path.join(WORK, f"cap_host{i}.dat")
        rows[i * a_local:(i + 1) * a_local].tofile(host_cap)
        uid = f"/smoke_{uuid.uuid4().hex[:8]}_{i}"
        dump = os.path.join(WORK, f"dist_dump{i}.dat")
        dumps.append(dump)
        rxs.append(r.spawn(f"rx_app host{i}", r.module(
            "rx_app", "--file", host_cap, "--shm-uid", uid, "--thres", 0.05,
            "--wait-writes", "--num-frames", MULTI_FRAMES, "--timeout", 300,
            "--pn-file", os.path.join(WORK, "pn.dat"),
            *geom_args(g, a_local)), r.cpu_env))
        env = dict(r.dev_env)
        if r.rehearse:
            env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
        dms.append(r.spawn(f"demod_app proc{i}", r.module(
            "demod_app", "--distributed", f"localhost:{port}",
            "--num-processes", nproc, "--process-id", i,
            "--local-devices", i if not r.rehearse else 0,
            "--shm-uid", uid, "--output", out, "--num-frames", MULTI_FRAMES,
            "--timeout", 300, "--pilots", os.path.join(WORK, "pilots.dat"),
            "--dump-symbols", dump, "--no-timer",
            *geom_args(g, a)), env))
    r.finish(dms + rxs, 600)
    for p in dms:
        log = open(os.path.join(WORK, f"{p._name}.log")).read()
        want = f"antenna shards on processes {list(range(nproc))}"
        if want not in log:
            raise PhaseFailed(f"{p._name}: antennas not split one block per "
                              f"process in order ({want!r} not logged)")
    print(f"  [distributed] antenna block i on process i, i < {nproc}")
    score(r, g, "distributed", out, dumps, sent, antennas=a,
          frames=MULTI_FRAMES)


def parent(args) -> int:
    g = SMALL if args.rehearse else FULL
    r = Runner(args.rehearse)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    phase = "device"
    try:
        print("== phase 1: device", flush=True)
        dev = phase_device(r)
        want = 4 if args.multi else 1
        if not args.rehearse and dev["count"] < want:
            raise PhaseFailed(f"{want} GPU(s) needed, JAX sees "
                              f"{dev['count']}")
        phase = "native"
        print("== phase 2: native build", flush=True)
        phase_native(r)
        if args.multi:
            phase = "mesh"
            print("== phase 6: demod_app --mesh 4x1 (64 antennas)", flush=True)
            cap, sent = phase_mesh(r, g)
            phase = "distributed"
            print("== phase 7: demod_app --distributed, 4 processes",
                  flush=True)
            phase_distributed(r, g, cap, sent)
        else:
            phase = "numerics"
            print("== phase 3: numerics at "
                  f"{g['antennas']}x{g['fft']}x{g['frame_len']}", flush=True)
            r.run("numerics", r.child(
                "numerics", "--antennas", g["antennas"], "--fft", g["fft"],
                "--cp", g["cp"], "--frame-len", g["frame_len"]),
                r.dev_env, 400)
            phase_gpu_tests(r)
            phase = "main path"
            print("== phase 4: main path (tx -> rx ring -> demod -> compare)",
                  flush=True)
            phase_main_path(r, g)
            phase = "bench"
            print("== phase 5: bench", flush=True)
            phase_bench(r)
    except PhaseFailed as e:
        print(f"FAILED in phase {phase}: {e}", file=sys.stderr)
        print(f"chip_smoke: FAILED in phase {phase}")
        return 1
    finally:
        r.stop_all()
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - r.t0:.1f} s")
    if args.rehearse:
        print("rehearsal on the CPU: no result is printed", file=sys.stderr)
        return 3
    from ofdm_ls_mrc_tpu.utils.device import card_info
    print(card_info())         # name, power.limit: one line per card
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


# ---------------------------------------------------------------------------
# Child phases (each runs in its own process).
# ---------------------------------------------------------------------------

def child_device(args) -> int:
    import jax

    from ofdm_ls_mrc_tpu.utils.device import describe

    print(f"jax.devices(): {jax.devices()}")
    dev = describe()
    print(f"platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']} XLA_FLAGS={dev['xla_flags']!r}")
    if dev["platform"] != "gpu" and not args.rehearse:
        print(f"no GPU: JAX's platform is {dev['platform']!r}",
              file=sys.stderr)
        return 1
    print("DEVICE " + json.dumps(dev))
    return 0


def _rel_err(got, want) -> float:
    import numpy as np
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _check(name, got, gold, data=None) -> None:
    import numpy as np

    from ofdm_ls_mrc_tpu.sim import evm_db

    err = _rel_err(got, gold)
    line = f"{name}: rel max err vs golden {err:.3e} (<= {REL_ERR_MAX:g})"
    ok = err <= REL_ERR_MAX
    if data is not None:
        evm = evm_db(np.fft.fftshift(got, axes=-1), data)
        line += f", EVM {evm:.2f} dB (< {EVM_MAX_DB:g})"
        ok = ok and evm < EVM_MAX_DB
    print(line, flush=True)
    if not ok:
        raise SystemExit(f"{name}: outside the bounds")


def _channel_frame(a, f, cp, s, seed):
    """(rx_frame [S, A, F+cp], pilot, data) through a 25 dB 16-tap channel."""
    import numpy as np

    from ofdm_ls_mrc_tpu.sim import (ChannelModel, make_tx_frame,
                                     random_symbols)

    rng = np.random.default_rng(seed)
    data, _ = random_symbols(rng, (s - 1, f - 1), "16qam")
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    chan = ChannelModel(a, f, num_taps=min(16, cp), snr_db=25.0, seed=seed)
    return chan.apply(make_tx_frame(data, pilot, cp), cp), pilot, data


def child_numerics(args) -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ofdm_ls_mrc_tpu import FrameConfig
    from ofdm_ls_mrc_tpu.golden import dsp
    from ofdm_ls_mrc_tpu.golden.io import SC16_FULL_SCALE, complex_to_sc16
    from ofdm_ls_mrc_tpu.models import StreamingDemodulator, UplinkReceiver
    from ofdm_ls_mrc_tpu.ops.cplx import CArray
    from ofdm_ls_mrc_tpu.parallel import ShardedUplinkReceiver, make_mesh
    from ofdm_ls_mrc_tpu.utils import compile_cache

    compile_cache.enable()
    a, f, cp, s = args.antennas, args.fft, args.cp, args.frame_len
    frame, pilot, data = _channel_frame(a, f, cp, s, seed=9)
    gold = dsp.demod_frame(frame, pilot, cp)
    cfg = FrameConfig(num_antennas=a, fft_size=f, cyclic_prefix=cp,
                      frame_len=s)

    t0 = time.perf_counter()
    rx = UplinkReceiver(cfg, pilot)
    c = CArray.from_numpy(frame)
    compiled = rx._demod_frame.lower(c).compile()
    print(f"frame step compiled in {time.perf_counter() - t0:.2f} s; "
          f"memory_analysis: {compiled.memory_analysis()}")
    _check(f"UplinkReceiver composed cp={cp}",
           rx.demod_frame(frame).to_numpy(), gold, data)
    _check(f"UplinkReceiver fast cp={cp}",
           UplinkReceiver(cfg, pilot, pipeline="fast").demod_frame(
               frame).to_numpy(), gold, data)

    # CP stripped on the host (as the ring does) and sc16 on the wire.
    y = np.ascontiguousarray(frame[..., cp:])
    y = (0.5 * y / np.max(np.abs(y.view(np.float32)))).astype(np.complex64)
    iq = complex_to_sc16(y).reshape(y.shape + (2,))
    re16 = np.ascontiguousarray(iq[..., 0])
    im16 = np.ascontiguousarray(iq[..., 1])
    yq = ((re16.astype(np.float32) + 1j * im16.astype(np.float32))
          / SC16_FULL_SCALE).astype(np.complex64)
    cfg0 = FrameConfig(num_antennas=a, fft_size=f, cyclic_prefix=0,
                       frame_len=s)
    rx0 = UplinkReceiver(cfg0, pilot)
    got16 = rx0.demod_frame(CArray(jnp.asarray(re16),
                                   jnp.asarray(im16))).to_numpy()
    _check("UplinkReceiver composed cp=0 sc16", got16,
           dsp.demod_frame(yq, pilot, 0), data)

    sd = StreamingDemodulator(cfg, pilot)
    sd.push_pilot(frame[0])
    rows = np.stack([sd.push_symbol(frame[i]).to_numpy()
                     for i in range(1, s)])
    _check("StreamingDemodulator per-symbol", rows, gold, data)

    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    srx = ShardedUplinkReceiver(cfg, pilot, mesh)
    _check("ShardedUplinkReceiver 1x1", srx.demod_frame(frame).to_numpy(),
           gold, data)
    return 0


def child_multi_numerics(args) -> int:
    import jax
    import numpy as np

    from ofdm_ls_mrc_tpu import FrameConfig
    from ofdm_ls_mrc_tpu.golden import dsp
    from ofdm_ls_mrc_tpu.models import UplinkReceiver
    from ofdm_ls_mrc_tpu.ops.cplx import CArray
    from ofdm_ls_mrc_tpu.parallel import ShardedUplinkReceiver, make_mesh
    from ofdm_ls_mrc_tpu.parallel.structure import (assert_single_fused_psum,
                                                    fused_psum_signature)
    from ofdm_ls_mrc_tpu.utils import compile_cache

    compile_cache.enable()
    devs = jax.devices()
    print(f"devices: {devs}")
    if len(devs) < 4:
        raise SystemExit(f"--multi needs 4 devices, JAX sees {len(devs)}")
    a, f, cp, s = args.antennas, args.fft, args.cp, args.frame_len
    frame, pilot, data = _channel_frame(a, f, cp, s, seed=21)
    gold = dsp.demod_frame(frame, pilot, cp)
    cfg = FrameConfig(num_antennas=a, fft_size=f, cyclic_prefix=cp,
                      frame_len=s)
    one = UplinkReceiver(cfg, pilot).demod_frame(frame).to_numpy()
    _check("UplinkReceiver on one card", one, gold, data)
    rx = ShardedUplinkReceiver(cfg, pilot, make_mesh(4, 1, devices=devs[:4]))
    got = rx.demod_frame(frame).to_numpy()
    _check("ShardedUplinkReceiver 4x1", got, gold, data)
    err = _rel_err(got, one)
    print(f"4x1 mesh vs one card: rel max err {err:.3e}")
    if err > REL_ERR_MAX:
        raise SystemExit("4x1 mesh disagrees with the single card")
    count, words = fused_psum_signature(rx, frame)
    assert_single_fused_psum(rx, frame, cfg, 1)
    print(f"sharded step: {count} all-reduce of {words} fp32 words "
          f"(expected (2*{s - 1}+1)*{f})")
    c = CArray.from_numpy(frame)
    txt = rx._demod.lower(c[0], c[1:], rx.x_full).compile().as_text()
    for ln in txt.splitlines():
        if "all-reduce" in ln and "=" in ln:
            print(f"HLO: {ln.strip()[:200]}")
    return 0


def child_golden(args) -> int:
    """Golden of the symbols demod_app read (its --dump-symbols), frame
    count, per-frame EVM against the sent grid, and max relative error."""
    import numpy as np

    from ofdm_ls_mrc_tpu.golden import dsp
    from ofdm_ls_mrc_tpu.golden.io import append_output, load_pilot, read_output

    a, f, s, k = args.antennas, args.fft, args.frame_len, args.frames
    pilot = load_pilot(os.path.join(WORK, "pilots.dat"), f - 1)
    dumps = [np.fromfile(p, dtype=np.complex64).reshape(k, s, -1, f)
             for p in args.dumps.split(",")]
    frames = np.concatenate(dumps, axis=2)
    if frames.shape[2] != a:
        raise SystemExit(f"dumps hold {frames.shape[2]} antennas, want {a}")
    gold = np.concatenate([dsp.demod_frame(frames[i], pilot, 0)
                           for i in range(k)])
    append_output(args.gold, gold, truncate=True)
    out = read_output(args.out, f - 1)
    if out.shape[0] != k * (s - 1):
        raise SystemExit(f"{out.shape[0]} rows written, want {k * (s - 1)}")
    err = _rel_err(out, gold)
    sent = np.fromfile(args.sent, dtype=np.complex64).reshape(k, s - 1, f - 1)
    evms = []
    for i in range(k):
        got = np.fft.fftshift(out[i * (s - 1):(i + 1) * (s - 1)], axes=-1)
        evms.append(float(10 * np.log10(np.mean(np.abs(got - sent[i]) ** 2)
                                        / np.mean(np.abs(sent[i]) ** 2))))
    print(f"{k} frames written; rel max err vs golden {err:.3e}; "
          f"per-frame EVM max {max(evms):.2f} dB, min {min(evms):.2f} dB")
    if err > REL_ERR_MAX or max(evms) >= EVM_MAX_DB:
        raise SystemExit("outside the bounds")
    return 0


def child_agree(args) -> int:
    from ofdm_ls_mrc_tpu.golden.io import read_output

    a = read_output(args.files[0], int(args.files[2]) - 1)
    b = read_output(args.files[1], int(args.files[2]) - 1)
    if a.shape != b.shape:
        raise SystemExit(f"shapes differ: {a.shape} vs {b.shape}")
    err = _rel_err(b, a)
    print(f"rel max err between the two outputs: {err:.3e}")
    if err > REL_ERR_MAX:
        raise SystemExit("outputs disagree")
    return 0


CHILDREN = {"device": child_device, "numerics": child_numerics,
            "multi-numerics": child_multi_numerics, "golden": child_golden,
            "agree": child_agree}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card paths (--mesh 4x1 and "
                         "--distributed with four processes)")
    ap.add_argument("--rehearse", action="store_true",
                    help="small CPU dry run of the orchestration; exits 3 "
                         "and prints no result")
    ap.add_argument("--phase", choices=sorted(CHILDREN), help=argparse.SUPPRESS)
    for name in ("--antennas", "--fft", "--cp", "--frame-len", "--frames"):
        ap.add_argument(name, type=int, help=argparse.SUPPRESS)
    for name in ("--out", "--gold", "--sent", "--dumps"):
        ap.add_argument(name, help=argparse.SUPPRESS)
    ap.add_argument("files", nargs="*", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.phase:
        return CHILDREN[args.phase](args)
    if args.files:
        ap.error(f"unexpected arguments: {' '.join(args.files)}")
    return parent(args)


if __name__ == "__main__":
    sys.exit(main())
