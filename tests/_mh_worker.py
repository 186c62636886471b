"""Worker process for the N-process jax.distributed multihost tests.

Launched by tests/test_multihost.py with env:
  MH_COORD=127.0.0.1:<port>  MH_NPROC=<N>  MH_PID=<0..N-1>
  MH_LOCAL_DEVICES=<devices per process, default 4>
Each process owns MH_LOCAL_DEVICES virtual CPU devices; the
(ant=local, time=N) mesh puts the MRC psum inside each process and shards
time across processes -- the exact topology recipe from parallel/multihost.py.
"""

import os
import sys

NPROC = int(os.environ.get("MH_NPROC", "2"))
LOCAL_DEVS = int(os.environ.get("MH_LOCAL_DEVICES", "4"))

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={LOCAL_DEVS}"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main() -> int:
    from ofdm_ls_mrc_tpu import FrameConfig
    from ofdm_ls_mrc_tpu.golden import dsp
    from ofdm_ls_mrc_tpu.parallel import ShardedUplinkReceiver
    from ofdm_ls_mrc_tpu.parallel.multihost import (
        global_from_host_blocks,
        initialize,
        make_multihost_mesh,
    )

    pid = int(os.environ["MH_PID"])
    initialize(coordinator_address=os.environ["MH_COORD"],
               num_processes=NPROC, process_id=pid)
    assert jax.process_count() == NPROC, jax.process_count()
    assert jax.local_device_count() == LOCAL_DEVS

    cfg = FrameConfig(num_antennas=4, fft_size=64, cyclic_prefix=8, frame_len=9)
    rng = np.random.default_rng(123)  # same seed everywhere: shared truth
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
    frame = (rng.standard_normal((cfg.frame_len, cfg.num_antennas, cfg.symbol_len))
             + 1j * rng.standard_normal((cfg.frame_len, cfg.num_antennas,
                                         cfg.symbol_len))).astype(np.complex64)
    want = dsp.demod_frame(frame, pilot, cfg.cyclic_prefix)

    mesh = make_multihost_mesh()       # (ant=local devices, time=processes)
    rx = ShardedUplinkReceiver(cfg, pilot, mesh, fft_impl="four_step")

    # Each process contributes only ITS time-block of the data symbols,
    # physically read from its OWN local shm ring (the per-host ingest story:
    # one SDR front-end + ring per host, parallel/multihost.py docstring) --
    # no host ever holds the whole capture.
    import threading
    import uuid

    from ofdm_ls_mrc_tpu.io.ring import SymbolRing

    data = frame[1:]
    s_local = data.shape[0] // NPROC
    block = data[pid * s_local:(pid + 1) * s_local]

    uid = f"/mh_{uuid.uuid4().hex[:8]}_{pid}"
    w = SymbolRing(uid, cfg.num_antennas, cfg.symbol_len, s_local + 1,
                   master=True, timeout=30.0)
    r = SymbolRing(uid, cfg.num_antennas, cfg.symbol_len, s_local + 1,
                   master=False, timeout=30.0)
    errs = []

    def produce():
        try:
            for k in range(s_local):
                w.write(block[k])
        except BaseException as e:  # surface writer failures, don't hang
            errs.append(e)

    t = threading.Thread(target=produce)
    t.start()
    try:
        re_pl, im_pl = r.read_frame_planar(s_local, cp=0)
        t.join(timeout=30)
        if errs:
            raise errs[0]
        local = (re_pl + 1j * im_pl).astype(np.complex64)
        np.testing.assert_array_equal(local, block)
        gdata = global_from_host_blocks(local, mesh)
    finally:
        r.close()
        w.close()

    # Pilot is replicated over time (every host's radio sees the pilot).
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ofdm_ls_mrc_tpu.ops.cplx import CArray
    ps = NamedSharding(mesh, P("ant", None))
    pre = np.ascontiguousarray(frame[0].real, np.float32)
    pim = np.ascontiguousarray(frame[0].imag, np.float32)
    gpilot = CArray(jax.make_array_from_process_local_data(ps, pre),
                    jax.make_array_from_process_local_data(ps, pim))

    out = rx.demod_pilot_data(gpilot, gdata)
    # Output is time-sharded: this process's local shards hold its block.
    shard = out.re.addressable_shards[0]
    got_re = np.asarray(shard.data)
    got_im = np.asarray(out.im.addressable_shards[0].data)
    got = got_re + 1j * got_im
    want_local = want[pid * s_local:(pid + 1) * s_local]
    err = np.max(np.abs(got - want_local)) / max(np.max(np.abs(want_local)), 1e-9)
    print(f"[proc {pid}] rel err vs golden: {err:.2e}", flush=True)
    assert err < 3e-3, err

    # Second leg: the default composed shard body (jnp.fft + XLA-fused
    # LS/MRC) at the reference 1024-point FFT composed with
    # jax.distributed -- same psum + mesh topology as a multi-card run.
    cfg2 = FrameConfig(num_antennas=4, fft_size=1024, cyclic_prefix=8,
                       frame_len=5)
    pilot2 = np.exp(2j * np.pi * rng.random(cfg2.num_subcarriers)
                    ).astype(np.complex64)
    frame2 = (rng.standard_normal((cfg2.frame_len, cfg2.num_antennas,
                                   cfg2.symbol_len))
              + 1j * rng.standard_normal((cfg2.frame_len, cfg2.num_antennas,
                                          cfg2.symbol_len))
              ).astype(np.complex64)
    want2 = dsp.demod_frame(frame2, pilot2, cfg2.cyclic_prefix)
    rx2 = ShardedUplinkReceiver(cfg2, pilot2, mesh)
    assert rx2.pipeline == "composed", rx2.pipeline

    data2 = frame2[1:]
    s_local2 = data2.shape[0] // NPROC
    gdata2 = global_from_host_blocks(
        data2[pid * s_local2:(pid + 1) * s_local2], mesh)
    gpilot2 = CArray(
        jax.make_array_from_process_local_data(
            ps, np.ascontiguousarray(frame2[0].real, np.float32)),
        jax.make_array_from_process_local_data(
            ps, np.ascontiguousarray(frame2[0].imag, np.float32)))
    out2 = rx2.demod_pilot_data(gpilot2, gdata2)
    got2 = (np.asarray(out2.re.addressable_shards[0].data)
            + 1j * np.asarray(out2.im.addressable_shards[0].data))
    want2_local = want2[pid * s_local2:(pid + 1) * s_local2]
    err2 = (np.max(np.abs(got2 - want2_local))
            / max(np.max(np.abs(want2_local)), 1e-9))
    print(f"[proc {pid}] composed rel err vs golden: {err2:.2e}", flush=True)
    assert err2 < 5e-4, err2

    # Third leg: ANTENNAS across hosts (BASELINE config 5's 64-antenna
    # split) -- each process contributes its own antennas' [S, A_local, F]
    # block for ALL symbols (global_from_antenna_blocks), pilot and data
    # are sliced inside one jit (demod_app --distributed does the same),
    # and the fused MRC psum is the only cross-process traffic.
    from ofdm_ls_mrc_tpu.parallel.multihost import global_from_antenna_blocks

    cfg3 = FrameConfig(num_antennas=8, fft_size=1024, cyclic_prefix=0,
                       frame_len=3)
    pilot3 = np.exp(2j * np.pi * rng.random(cfg3.num_subcarriers)
                    ).astype(np.complex64)
    frame3 = (rng.standard_normal((cfg3.frame_len, cfg3.num_antennas,
                                   cfg3.symbol_len))
              + 1j * rng.standard_normal((cfg3.frame_len, cfg3.num_antennas,
                                          cfg3.symbol_len))
              ).astype(np.complex64)
    want3 = dsp.demod_frame(frame3, pilot3, 0)
    mesh3 = make_multihost_mesh(ant_shards=8, time_shards=1)
    rx3 = ShardedUplinkReceiver(cfg3, pilot3, mesh3)

    a_local = cfg3.num_antennas // NPROC
    block3 = frame3[:, pid * a_local:(pid + 1) * a_local]
    gframe3 = global_from_antenna_blocks(block3, mesh3)
    out3 = jax.jit(lambda c: rx3._demod(c[0], c[1:], rx3.x_full))(gframe3)
    got3 = (np.asarray(out3.re.addressable_shards[0].data)
            + 1j * np.asarray(out3.im.addressable_shards[0].data))
    err3 = np.max(np.abs(got3 - want3)) / np.max(np.abs(want3))
    print(f"[proc {pid}] antenna-sharded whole-frame rel err: {err3:.2e}",
          flush=True)
    assert err3 < 5e-4, err3
    return 0


if __name__ == "__main__":
    sys.exit(main())
