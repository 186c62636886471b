"""Sharded pipeline tests on the 8-device virtual CPU mesh."""

import jax
import numpy as np
import pytest

from ofdm_ls_mrc_tpu import FrameConfig
from ofdm_ls_mrc_tpu.golden import dsp
from ofdm_ls_mrc_tpu.parallel import (
    ShardedUplinkReceiver,
    frame_sharding,
    make_mesh,
)


def crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must force 8 virtual CPU devices"
    return devs


CFG = FrameConfig(num_antennas=8, fft_size=64, cyclic_prefix=8, frame_len=9)


def _golden(frame, pilot):
    return dsp.demod_frame(frame, pilot, CFG.cyclic_prefix)


@pytest.mark.parametrize("ant_shards,time_shards", [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2)])
def test_sharded_matches_golden(rng, devices, ant_shards, time_shards):
    pilot = np.exp(2j * np.pi * rng.random(CFG.num_subcarriers)).astype(np.complex64)
    frame = crandn(rng, (CFG.frame_len, CFG.num_antennas, CFG.symbol_len))
    mesh = make_mesh(ant_shards, time_shards)
    rx = ShardedUplinkReceiver(CFG, pilot, mesh, fft_impl="four_step")
    got = rx.demod_frame(frame).to_numpy()
    np.testing.assert_allclose(got, _golden(frame, pilot), rtol=3e-3, atol=3e-3)


def test_sharded_matches_single_device(rng, devices):
    from ofdm_ls_mrc_tpu.models import UplinkReceiver

    pilot = np.exp(2j * np.pi * rng.random(CFG.num_subcarriers)).astype(np.complex64)
    frame = crandn(rng, (CFG.frame_len, CFG.num_antennas, CFG.symbol_len))
    single = UplinkReceiver(CFG, pilot, fft_impl="four_step").demod_frame(frame).to_numpy()
    mesh = make_mesh(4, 2)
    sharded = ShardedUplinkReceiver(CFG, pilot, mesh, fft_impl="four_step")
    got = sharded.demod_frame(frame).to_numpy()
    np.testing.assert_allclose(got, single, atol=1e-4)


def test_sharded_capture_matches_per_frame(rng, devices):
    pilot = np.exp(2j * np.pi * rng.random(CFG.num_subcarriers)).astype(np.complex64)
    cap = crandn(rng, (3, CFG.frame_len, CFG.num_antennas, CFG.symbol_len))
    rx = ShardedUplinkReceiver(CFG, pilot, make_mesh(4, 2), fft_impl="four_step")
    got = rx.demod_capture(cap).to_numpy()
    want = np.stack([rx.demod_frame(cap[k]).to_numpy() for k in range(3)])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sharded_fused_kernel_matches_golden(rng, devices):
    """The default shard body (jnp.fft + XLA-fused local LS/MRC numerator,
    one psum) at the reference 1024-point FFT, on a 2x2 mesh."""
    cfg = FrameConfig(num_antennas=4, fft_size=1024, cyclic_prefix=16,
                      frame_len=5)
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
    frame = crandn(rng, (cfg.frame_len, cfg.num_antennas, cfg.symbol_len))
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    rx = ShardedUplinkReceiver(cfg, pilot, mesh)
    assert rx.pipeline == "composed"
    got = rx.demod_frame(frame).to_numpy()
    want = dsp.demod_frame(frame, pilot, cfg.cyclic_prefix)
    np.testing.assert_allclose(got, want, rtol=3e-3, atol=3e-3)


def test_sharded_fused_falls_back(rng, devices):
    """No silent fallback: the removed 'fused' body is an unknown pipeline,
    and 'fast' runs as asked at a 64-point FFT."""
    pilot = np.exp(2j * np.pi * rng.random(CFG.num_subcarriers)).astype(np.complex64)
    with pytest.raises(ValueError, match="unknown pipeline"):
        ShardedUplinkReceiver(CFG, pilot, make_mesh(2, 2), pipeline="fused")
    rx = ShardedUplinkReceiver(CFG, pilot, make_mesh(2, 2), pipeline="fast")
    assert rx.pipeline == "fast"


def test_pre_placed_inputs(rng, devices):
    pilot = np.exp(2j * np.pi * rng.random(CFG.num_subcarriers)).astype(np.complex64)
    frame = crandn(rng, (CFG.frame_len, CFG.num_antennas, CFG.symbol_len))
    mesh = make_mesh(4, 2)
    rx = ShardedUplinkReceiver(CFG, pilot, mesh, fft_impl="four_step")
    p, d = rx.place(frame)
    got = rx.demod_pilot_data(p, d).to_numpy()
    np.testing.assert_allclose(got, _golden(frame, pilot), rtol=3e-3, atol=3e-3)


def test_output_sharding_layout(rng, devices):
    """Output is time-sharded: each row block lives on one time shard."""
    pilot = np.exp(2j * np.pi * rng.random(CFG.num_subcarriers)).astype(np.complex64)
    frame = crandn(rng, (CFG.frame_len, CFG.num_antennas, CFG.symbol_len))
    mesh = make_mesh(2, 4)
    rx = ShardedUplinkReceiver(CFG, pilot, mesh, fft_impl="four_step")
    out = rx.demod_frame(frame)
    spec = out.re.sharding.spec
    assert spec[0] == "time"


def test_indivisible_shards_rejected(rng, devices):
    pilot = np.exp(2j * np.pi * rng.random(CFG.num_subcarriers)).astype(np.complex64)
    mesh = make_mesh(3, 1, devices=jax.devices()[:3])
    with pytest.raises(ValueError, match="not divisible"):
        ShardedUplinkReceiver(CFG, pilot, mesh)


def test_sharded_misconfigurations_fail_loud(rng, devices):
    """Construction/dispatch errors surface as precise messages, not
    opaque downstream shape errors (same contract as UplinkReceiver)."""
    from ofdm_ls_mrc_tpu.parallel.multihost import make_multihost_mesh

    pilot = np.exp(2j * np.pi * rng.random(CFG.num_subcarriers)).astype(np.complex64)
    # Wrong-length pilot rejected at construction.
    with pytest.raises(ValueError, match="pilot has"):
        ShardedUplinkReceiver(CFG, pilot[:-2], make_mesh(2, 1))
    # Oversubscribed multihost mesh rejected with the device math.
    with pytest.raises(ValueError, match="needs .* devices"):
        make_multihost_mesh(ant_shards=len(jax.devices()), time_shards=2)
    # Unknown FFT implementation rejected at construction.
    with pytest.raises(ValueError, match="unknown fft_impl"):
        ShardedUplinkReceiver(CFG, pilot, make_mesh(2, 1), fft_impl="dft")


def test_multihost_initialize_passes_partial_kwargs(monkeypatch):
    """initialize() forwards exactly the fields the caller pinned --
    dropping num_processes/process_id when no coordinator is given would
    silently auto-configure the wrong topology."""
    from ofdm_ls_mrc_tpu.parallel import multihost

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    multihost.initialize(num_processes=4, process_id=2)
    assert seen == {"num_processes": 4, "process_id": 2}
    seen.clear()
    multihost.initialize("h:1", 2, 0)
    assert seen == {"coordinator_address": "h:1",
                    "num_processes": 2, "process_id": 0}
    seen.clear()
    multihost.initialize("h:1", 4, 3, local_device_ids=[3])
    assert seen == {"coordinator_address": "h:1", "num_processes": 4,
                    "process_id": 3, "local_device_ids": [3]}
    seen.clear()
    multihost.initialize()
    assert seen == {}


def test_parallel_exports_antenna_blocks():
    from ofdm_ls_mrc_tpu.parallel import global_from_antenna_blocks  # noqa: F401


class TestShardedDownlink:
    """Subcarrier-sharded ZF precode + row-sharded modulate vs the golden."""

    def test_precode_matches_golden(self, rng, devices):
        from ofdm_ls_mrc_tpu.parallel import ShardedDownlinkTransmitter

        cfg = CFG
        users, ants, subs = 4, cfg.num_antennas, cfg.num_subcarriers
        h = crandn(rng, (subs, users, ants))
        x = crandn(rng, (users, subs))
        tx = ShardedDownlinkTransmitter(cfg, make_mesh(4, 2))
        got = tx.precode(h, x).to_numpy()
        want = dsp.apply_precoder(dsp.zf_precoder(h), x)
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)

    def test_precode_zero_forces_interference(self, rng, devices):
        """h @ precoded == user symbols exactly (the ZF property), per subcarrier."""
        from ofdm_ls_mrc_tpu.parallel import ShardedDownlinkTransmitter

        cfg = CFG
        users, ants, subs = 2, cfg.num_antennas, cfg.num_subcarriers
        h = crandn(rng, (subs, users, ants))
        x = crandn(rng, (users, subs))
        tx = ShardedDownlinkTransmitter(cfg, make_mesh(2, 4))
        ant_streams = tx.precode(h, x).to_numpy()          # [A, S']
        rx_users = np.einsum("sua,as->us", h, ant_streams)
        np.testing.assert_allclose(rx_users, x, rtol=5e-3, atol=5e-3)

    def test_modulate_matches_golden(self, rng, devices):
        from ofdm_ls_mrc_tpu.parallel import ShardedDownlinkTransmitter

        cfg = CFG
        data = crandn(rng, (cfg.num_antennas, cfg.num_subcarriers))
        tx = ShardedDownlinkTransmitter(cfg, make_mesh(4, 2), fft_impl="four_step")
        got = tx.modulate(data).to_numpy()
        want = dsp.modulate_symbol(data, cp=cfg.cyclic_prefix)
        np.testing.assert_allclose(got, want, rtol=3e-3, atol=3e-3)

    def test_precode_output_stays_sharded(self, rng, devices):
        """With a divisible subcarrier count (no pad/trim), the antenna-stream
        result keeps its subcarrier sharding -- no gather until the host asks."""
        from ofdm_ls_mrc_tpu.parallel import ShardedDownlinkTransmitter

        cfg = CFG
        subs = 64  # divisible by the 4-device mesh: the edge slice is a no-op
        h = crandn(rng, (subs, 2, cfg.num_antennas))
        x = crandn(rng, (2, subs))
        tx = ShardedDownlinkTransmitter(cfg, make_mesh(2, 2, devices=jax.devices()[:4]))
        out = tx.precode(h, x)
        assert not out.re.sharding.is_fully_replicated


def test_global_from_host_blocks_single_process(rng, devices):
    """make_array_from_process_local_data path (single-process simulation)."""
    from ofdm_ls_mrc_tpu.parallel.multihost import global_from_host_blocks
    from ofdm_ls_mrc_tpu.parallel import make_mesh

    mesh = make_mesh(2, 4)
    block = crandn(rng, (8, CFG.num_antennas, CFG.fft_size))
    g = global_from_host_blocks(block, mesh)
    assert g.shape == (8, CFG.num_antennas, CFG.fft_size)
    np.testing.assert_allclose(g.to_numpy(), block, atol=1e-6)


def test_sharded_fused_accepts_int16_shards(rng, devices):
    """sc16-native planar int16 frames through both shard bodies: the
    planes widen inside the shard body, and the result matches the f32
    path on identically quantized data."""
    import jax.numpy as jnp

    from ofdm_ls_mrc_tpu.ops.cplx import CArray

    cfg = FrameConfig(num_antennas=4, fft_size=1024, cyclic_prefix=0,
                      frame_len=5)
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)
                   ).astype(np.complex64)
    frame = (0.1 * crandn(rng, (cfg.frame_len, cfg.num_antennas,
                                cfg.symbol_len)))
    q = np.round(frame.view(np.float32) * 32767).astype(np.int16)
    frame_q = (q.astype(np.float32) / 32767).view(np.complex64).reshape(
        frame.shape)
    sh = frame.shape + (2,)
    re16 = jnp.asarray(np.ascontiguousarray(q.reshape(sh)[..., 0]))
    im16 = jnp.asarray(np.ascontiguousarray(q.reshape(sh)[..., 1]))
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    for pipeline in ("composed", "fast"):
        rx = ShardedUplinkReceiver(cfg, pilot, mesh, pipeline=pipeline)
        want = rx.demod_frame(frame_q).to_numpy()
        got = rx.demod_frame(CArray(re16, im16)).to_numpy()
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err < 1e-5, (pipeline, err)


class TestCompiledStructure:
    """parallel.structure: the compiled collective signature (the machinery
    behind dryrun_multichip's assertion and tools/scaling_bench.py)."""

    def test_single_fused_psum_and_payload(self, rng, devices):
        from ofdm_ls_mrc_tpu.parallel.structure import (
            assert_single_fused_psum, expected_psum_payload_words,
            fused_psum_signature)
        pilot = np.exp(2j * np.pi * rng.random(CFG.num_subcarriers)
                       ).astype(np.complex64)
        frame = crandn(rng, (CFG.frame_len, CFG.num_antennas, CFG.symbol_len))
        for ant_shards in (2, 4):
            mesh = make_mesh(ant_shards, 1)
            rx = ShardedUplinkReceiver(CFG, pilot, mesh,
                                       fft_impl="four_step")
            count, words = fused_psum_signature(rx, frame)
            assert count == 1
            # (2*S_data + 1) * F, independent of the antenna-shard count.
            assert words == expected_psum_payload_words(CFG, 1)
            assert words == (2 * (CFG.frame_len - 1) + 1) * CFG.fft_size
            assert_single_fused_psum(rx, frame, CFG, 1)

    @pytest.mark.parametrize("text,want", [
        ("%all-reduce = (f32[8,64]{1,0}, f32[64]{0}) all-reduce(%a, %b), "
         "channel_id=1", (1, 8 * 64 + 64)),
        ("%all-reduce-start = (f32[100,1024]{1,0}, f32[1024]{0}, "
         "f32[100,1024]{1,0}) all-reduce-start(%x, %y, %z), channel_id=1\n"
         "%all-reduce-done = (f32[100,1024]{1,0}, f32[1024]{0}, "
         "f32[100,1024]{1,0}) all-reduce-done(%all-reduce-start)",
         (1, 201 * 1024)),
        ("%gte = f32[64]{0} get-tuple-element(%all-reduce), index=1", (0, 0)),
    ], ids=["sync", "gpu-async-pair", "use-only"])
    def test_signature_reads_sync_and_async_all_reduce(self, text, want):
        """The GPU compiler emits all-reduce-start/-done pairs: one
        collective, counted once; uses of its result are not collectives."""
        from ofdm_ls_mrc_tpu.parallel.structure import collective_signature
        assert collective_signature(text) == want

    def test_payload_shrinks_with_time_shards(self, rng, devices):
        from ofdm_ls_mrc_tpu.parallel.structure import (
            expected_psum_payload_words)
        full = expected_psum_payload_words(CFG, 1)
        half = expected_psum_payload_words(CFG, 2)
        assert half == (CFG.num_data_symbols + 1) * CFG.fft_size < full
