"""End-to-end pipeline tests: UplinkReceiver / DownlinkTransmitter vs golden."""

import jax
import numpy as np
import pytest

from ofdm_ls_mrc_tpu import FrameConfig
from ofdm_ls_mrc_tpu.golden import dsp
from ofdm_ls_mrc_tpu.models import DownlinkTransmitter, UplinkReceiver
from ofdm_ls_mrc_tpu.sim import ChannelModel, evm_db, make_tx_frame, random_symbols


def crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


@pytest.fixture
def small_cfg():
    return FrameConfig(num_antennas=4, fft_size=64, cyclic_prefix=8, frame_len=9)


class TestUplinkReceiver:
    @pytest.mark.parametrize("fft_impl", ["xla", "matmul", "four_step"])
    def test_matches_golden(self, rng, small_cfg, fft_impl):
        cfg = small_cfg
        pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
        frame = crandn(rng, (cfg.frame_len, cfg.num_antennas, cfg.symbol_len))

        want = dsp.demod_frame(frame, pilot, cfg.cyclic_prefix)
        rx = UplinkReceiver(cfg, pilot, fft_impl=fft_impl, donate=False)
        got = rx.demod_frame(frame).to_numpy()
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)

    def test_split_phase_matches_whole_frame(self, rng, small_cfg):
        cfg = small_cfg
        pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
        frame = crandn(rng, (cfg.frame_len, cfg.num_antennas, cfg.symbol_len))
        rx = UplinkReceiver(cfg, pilot, donate=False)
        whole = rx.demod_frame(frame).to_numpy()
        h = rx.estimate_channel(frame[0])
        split = rx.demod_data(frame[1:], *h).to_numpy()
        np.testing.assert_allclose(whole, split, atol=1e-5)

    def test_loopback_evm_through_channel(self, rng, small_cfg):
        cfg = small_cfg
        data, _ = random_symbols(rng, (cfg.num_data_symbols, cfg.num_subcarriers), "qpsk")
        pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
        tx = make_tx_frame(data, pilot, cfg.cyclic_prefix)
        chan = ChannelModel(cfg.num_antennas, cfg.fft_size, num_taps=4,
                            snr_db=35.0, seed=3)
        rx_frame = chan.apply(tx, cfg.cyclic_prefix)
        rx = UplinkReceiver(cfg, pilot, donate=False)
        out = np.fft.fftshift(rx.demod_frame(rx_frame).to_numpy(), axes=-1)
        assert evm_db(out, data) < -25.0

    def test_demod_capture_matches_per_frame(self, rng, small_cfg):
        cfg = small_cfg
        pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
        cap = crandn(rng, (3, cfg.frame_len, cfg.num_antennas, cfg.symbol_len))
        rx = UplinkReceiver(cfg, pilot)
        got = rx.demod_capture(cap).to_numpy()
        want = np.stack([rx.demod_frame(cap[k]).to_numpy() for k in range(3)])
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_fused_pipeline_matches_fast(self, rng):
        """The default body (jnp.fft + the LS/MRC chain XLA fuses) agrees
        with pipeline='fast' (DFT-as-GEMM at HIGHEST precision) at the
        reference FFT size."""
        cfg = FrameConfig(num_antennas=2, fft_size=1024, cyclic_prefix=16,
                          frame_len=4)
        pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
        frame = crandn(rng, (cfg.frame_len, cfg.num_antennas, cfg.symbol_len))
        fast_rx = UplinkReceiver(cfg, pilot, pipeline="fast")
        assert fast_rx.pipeline == "fast"
        fast = fast_rx.demod_frame(frame).to_numpy()
        default_rx = UplinkReceiver(cfg, pilot)
        assert default_rx.pipeline == "composed"
        fused = default_rx.demod_frame(frame).to_numpy()
        np.testing.assert_allclose(fused, fast, rtol=3e-4, atol=3e-4)

    def test_fused_pipeline_falls_back_without_128_split(self, rng, small_cfg):
        """No silent fallback: an unknown body (the removed 'fused' kernel
        included) is an error, and 'fast' runs as asked at any even FFT
        size -- no receiver downgrades its body behind the caller."""
        pilot = np.exp(2j * np.pi * rng.random(small_cfg.num_subcarriers)
                       ).astype(np.complex64)
        rx = UplinkReceiver(small_cfg, pilot, fft_impl="four_step",
                            pipeline="fast")
        assert rx.pipeline == "fast"  # 64-point FFT: (8, 8) split
        for bad in ("fused", "fastt"):
            with pytest.raises(ValueError, match="unknown pipeline"):
                UplinkReceiver(small_cfg, pilot, pipeline=bad)

    def test_reference_default_geometry(self, rng):
        """16 ant x 1024 FFT x 101 symbols -- the reference's GPU config."""
        cfg = FrameConfig()
        pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
        frame = crandn(rng, (cfg.frame_len, cfg.num_antennas, cfg.symbol_len))
        rx = UplinkReceiver(cfg, pilot, donate=False)
        got = rx.demod_frame(frame).to_numpy()
        assert got.shape == (100, 1023)
        want = dsp.demod_frame(frame, pilot, cfg.cyclic_prefix)
        # Spot-check a slice (full-frame allclose is covered at small size).
        np.testing.assert_allclose(got[::25], want[::25], rtol=3e-3, atol=3e-3)


class TestDownlinkTransmitter:
    def test_zf_then_uplink_channel(self, rng, small_cfg):
        """Precode for a known channel; each user's stream arrives clean."""
        cfg = small_cfg
        s, u, a = cfg.num_subcarriers, cfg.num_users, cfg.num_antennas
        h = crandn(rng, (s, u, a))
        x = crandn(rng, (u, s))
        tx = DownlinkTransmitter(cfg)
        ant = tx.precode(h, x).to_numpy()
        rx = np.einsum("sua,as->us", h, ant)
        np.testing.assert_allclose(rx, x, atol=1e-3)

    def test_modulate_matches_golden(self, rng, small_cfg):
        cfg = small_cfg
        data = crandn(rng, (cfg.num_antennas, cfg.num_subcarriers))
        tx = DownlinkTransmitter(cfg)
        got = tx.modulate(data).to_numpy()
        want = dsp.modulate_symbol(data, cp=cfg.cyclic_prefix)
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_modulate_frame_closes_loop_with_receiver(self, rng, small_cfg):
        cfg = small_cfg
        data, _ = random_symbols(rng, (cfg.num_data_symbols, cfg.num_subcarriers), "qpsk")
        pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
        tx = DownlinkTransmitter(cfg)
        frame_1stream = tx.modulate_frame(data, pilot).to_numpy()      # [S, F+cp]
        chan = ChannelModel(cfg.num_antennas, cfg.fft_size, num_taps=4,
                            snr_db=300.0, seed=4)
        rx_frame = chan.apply(frame_1stream, cfg.cyclic_prefix)
        rx = UplinkReceiver(cfg, pilot, donate=False)
        out = np.fft.fftshift(rx.demod_frame(rx_frame).to_numpy(), axes=-1)
        np.testing.assert_allclose(out, data, atol=1e-2)


def test_summarize_trace_parses_profiler_output(tmp_path, rng):
    """utils.profiling.summarize_trace aggregates per-op durations from a
    jax.profiler capture (works on the CPU backend too)."""
    import jax
    import jax.numpy as jnp
    import pytest

    from ofdm_ls_mrc_tpu.utils import profiling

    f = jax.jit(lambda x: jnp.sum(x * x))
    x = jnp.asarray(rng.standard_normal((256, 256)), jnp.float32)
    try:
        with profiling.trace(str(tmp_path)):
            for _ in range(3):
                out = f(x)
            jax.block_until_ready(out)
    except Exception as e:  # profiler availability varies by backend build
        pytest.skip(f"profiler unavailable: {e}")
    # CPU traces have no GPU track; host-side parse must still work.
    ops = profiling.summarize_trace(str(tmp_path), device_only=False)
    assert ops, "no events parsed"
    total, count = next(iter(ops.values()))
    assert total > 0 and count >= 1


def test_bench_sharded_harness_smoke(rng):
    """bench.bench_sharded runs on a 2-device virtual mesh and returns a
    positive per-frame time for both bodies and both wire formats;
    psum_payload_bytes matches the fused-psum payload formula
    (2*S_local + 1) * F * 4."""
    import os
    import sys
    sys.path.insert(0, os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..")))
    from bench import bench_sharded, psum_payload_bytes

    from ofdm_ls_mrc_tpu import FrameConfig

    cfg = FrameConfig(num_antennas=4, fft_size=64, cyclic_prefix=0,
                      frame_len=5)
    assert psum_payload_bytes(cfg, 1) == (2 * 4 + 1) * 64 * 4
    assert psum_payload_bytes(cfg, 2) == (2 * 2 + 1) * 64 * 4
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)
                   ).astype(np.complex64)
    frames = (0.25 * (rng.standard_normal((2, 5, 4, 64))
                      + 1j * rng.standard_normal((2, 5, 4, 64)))
              ).astype(np.complex64)
    for pipeline, inp, mesh in (("fast", "f32", (2, 1)),
                                ("composed", "sc16", (2, 1)),
                                ("composed", "f32", (2, 2))):
        t = bench_sharded(cfg, pilot, frames, reps=1, mesh_shape=mesh,
                          pipeline=pipeline, r_hi=3, input_dtype=inp)
        assert t > 0, (pipeline, inp, mesh)
