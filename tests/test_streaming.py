"""Streaming per-symbol demod vs whole-frame pipeline and golden."""

import numpy as np
import pytest

from ofdm_ls_mrc_tpu import FrameConfig
from ofdm_ls_mrc_tpu.golden import dsp
from ofdm_ls_mrc_tpu.models import StreamingDemodulator, UplinkReceiver
from ofdm_ls_mrc_tpu.utils.timing import PhaseTimer


def crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


CFG = FrameConfig(num_antennas=4, fft_size=64, cyclic_prefix=8, frame_len=6)


def test_streaming_matches_whole_frame(rng):
    pilot = np.exp(2j * np.pi * rng.random(CFG.num_subcarriers)).astype(np.complex64)
    frame = crandn(rng, (CFG.frame_len, CFG.num_antennas, CFG.symbol_len))
    whole = UplinkReceiver(CFG, pilot).demod_frame(frame).to_numpy()

    sd = StreamingDemodulator(CFG, pilot)
    sd.push_pilot(frame[0])
    rows = [sd.push_symbol(frame[i]).to_numpy() for i in range(1, CFG.frame_len)]
    np.testing.assert_allclose(np.stack(rows), whole, atol=1e-5)


def test_streaming_matches_golden(rng):
    pilot = np.exp(2j * np.pi * rng.random(CFG.num_subcarriers)).astype(np.complex64)
    frame = crandn(rng, (CFG.frame_len, CFG.num_antennas, CFG.symbol_len))
    want = dsp.demod_frame(frame, pilot, CFG.cyclic_prefix)
    sd = StreamingDemodulator(CFG, pilot)
    sd.push_pilot(frame[0])
    rows = [sd.push_symbol(frame[i]).to_numpy() for i in range(1, CFG.frame_len)]
    np.testing.assert_allclose(np.stack(rows), want, rtol=3e-3, atol=3e-3)


class TestFusedStreaming:
    """The per-symbol body at the reference FFT size (one jitted program
    per symbol that XLA fuses), across FFT implementations and restarts."""
    CFG1K = FrameConfig(num_antennas=2, fft_size=1024, cyclic_prefix=16,
                        frame_len=4)

    def test_fused_matches_composed(self, rng):
        cfg = self.CFG1K
        pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
        frame = crandn(rng, (cfg.frame_len, cfg.num_antennas, cfg.symbol_len))
        a = StreamingDemodulator(cfg, pilot, fft_impl="four_step")
        b = StreamingDemodulator(cfg, pilot)
        assert b.fft_impl == "xla"
        a.push_pilot(frame[0])
        b.push_pilot(frame[0])
        ra = a.push_symbol(frame[1]).to_numpy()
        rb = b.push_symbol(frame[1]).to_numpy()
        np.testing.assert_allclose(rb, ra, rtol=3e-4, atol=3e-4)

    def test_state_roundtrips_across_modes(self, rng, tmp_path):
        cfg = self.CFG1K
        pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
        frame = crandn(rng, (cfg.frame_len, cfg.num_antennas, cfg.symbol_len))
        src = StreamingDemodulator(cfg, pilot)
        src.push_pilot(frame[0])
        want = src.push_symbol(frame[1]).to_numpy()
        path = str(tmp_path / "est_state")
        src.save_state(path, frame_index=7)

        # Resume into another FFT implementation: same demod output (DC
        # excluded by construction -- it never reaches the 1023-wide output).
        other = StreamingDemodulator(cfg, pilot, fft_impl="four_step")
        assert other.resume(path) == 7
        got = other.push_symbol(frame[1]).to_numpy()
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)

        # And back into a fresh default instance.
        again = StreamingDemodulator(cfg, pilot)
        assert again.resume(path) == 7
        got2 = again.push_symbol(frame[1]).to_numpy()
        np.testing.assert_allclose(got2, want, rtol=1e-6, atol=1e-6)

    def test_fused_falls_back_small_fft(self, rng):
        """No silent fallback: an unknown FFT implementation is an error."""
        pilot = np.exp(2j * np.pi * rng.random(CFG.num_subcarriers)).astype(np.complex64)
        with pytest.raises(ValueError, match="unknown fft_impl"):
            StreamingDemodulator(CFG, pilot, fft_impl="fused")
        sd = StreamingDemodulator(CFG, pilot, fft_impl="four_step")
        assert sd.fft_impl == "four_step"


def _i16_planes(sym):
    """Quantize a complex symbol to sc16 wire format and return planar
    int16 CArray planes + the float value those planes represent."""
    from ofdm_ls_mrc_tpu.golden.io import SC16_FULL_SCALE, complex_to_sc16
    from ofdm_ls_mrc_tpu.ops.cplx import CArray

    s = complex_to_sc16(sym)
    re = np.ascontiguousarray(s[:, ::2])
    im = np.ascontiguousarray(s[:, 1::2])
    q = (re.astype(np.float32) + 1j * im.astype(np.float32)
         ).astype(np.complex64) / SC16_FULL_SCALE
    return CArray(re, im), q


@pytest.mark.parametrize("fft_impl,fft_size", [("xla", 64), ("xla", 1024),
                                               ("four_step", 256)])
def test_int16_streaming_matches_quantized_golden(rng, fft_impl, fft_size):
    """sc16-native per-symbol input: planar INT16 planes widen ON DEVICE
    (in-jit, before the FFT) and must match the NumPy golden on the
    quantized symbols (the per-symbol sc16 feed)."""
    cfg = FrameConfig(num_antennas=4, fft_size=fft_size, cyclic_prefix=0,
                      frame_len=4)
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)
                   ).astype(np.complex64)
    frame = crandn(rng, (cfg.frame_len, cfg.num_antennas, cfg.symbol_len)) * 0.05
    planes = [_i16_planes(s) for s in frame]
    want = dsp.demod_frame(np.stack([q for _, q in planes]), pilot, 0)
    sd = StreamingDemodulator(cfg, pilot, fft_impl=fft_impl)
    sd.warmup(int16=True)
    sd.push_pilot(planes[0][0])
    for i in range(1, cfg.frame_len):
        got = sd.push_symbol(planes[i][0]).to_numpy()
        np.testing.assert_allclose(got, want[i - 1], rtol=3e-3, atol=3e-3)


def test_requires_pilot_first(rng):
    pilot = np.exp(2j * np.pi * rng.random(CFG.num_subcarriers)).astype(np.complex64)
    sd = StreamingDemodulator(CFG, pilot)
    with pytest.raises(RuntimeError, match="push_pilot"):
        sd.push_symbol(crandn(rng, (CFG.num_antennas, CFG.symbol_len)))


def test_pilot_refresh_changes_estimate(rng):
    pilot = np.exp(2j * np.pi * rng.random(CFG.num_subcarriers)).astype(np.complex64)
    f1 = crandn(rng, (CFG.frame_len, CFG.num_antennas, CFG.symbol_len))
    f2 = crandn(rng, (CFG.frame_len, CFG.num_antennas, CFG.symbol_len))
    sd = StreamingDemodulator(CFG, pilot)
    sd.push_pilot(f1[0])
    a = sd.push_symbol(f1[1]).to_numpy()
    sd.push_pilot(f2[0])
    b = sd.push_symbol(f1[1]).to_numpy()
    assert not np.allclose(a, b)


def test_phase_timer_integration(rng):
    pilot = np.exp(2j * np.pi * rng.random(CFG.num_subcarriers)).astype(np.complex64)
    frame = crandn(rng, (CFG.frame_len, CFG.num_antennas, CFG.symbol_len))
    timer = PhaseTimer(num_slots=CFG.frame_len)
    sd = StreamingDemodulator(CFG, pilot, timer=timer)
    sd.push_pilot(frame[0], slot=0)
    for i in range(1, CFG.frame_len):
        sd.push_symbol(frame[i], slot=i)
    s = timer.summary()
    assert s["chanest"][0] > 0
    assert s["decode"][0] > 0
    assert timer.frame_latency() > 0


def test_timer_report_format():
    """Reference pattern: every slot accumulated num_times times, divided
    once at report time (printTimes /numTimes, ShMemSymBuff.hpp:154-157)."""
    t = PhaseTimer(num_slots=4, num_times=2)
    for p in ("read", "fft", "decode", "drop"):
        for i in range(4):
            t.add(p, i, 1e-3 * (i + 1))   # two accumulations per slot,
            t.add(p, i, 1e-3 * (i + 1))   # like numTimes=2 outer reps
    t.add("chanest", 0, 5e-3)
    t.add("chanest", 0, 5e-3)
    text = t.print_times()
    assert "Read:" in text and "ChanEst:" in text and "Frame latency" in text
    s = t.summary()
    # decode stats skip slot 0 (reference &decode[1]); per-slot totals divide
    # by the slot's own occurrence count (== num_times here).
    assert abs(s["decode"][0] - np.mean([2e-3, 3e-3, 4e-3])) < 1e-9
    assert abs(s["chanest"][0] - 5e-3) < 1e-9
    # printTimes-parity variance: the reference reports
    # var(per-slot totals)/numTimes = var(per-slot means) * numTimes here.
    means = np.array([2e-3, 3e-3, 4e-3])
    assert abs(s["decode"][1] - means.var() * 2) < 1e-15


def test_timer_uneven_slot_occupancy_hand_computed():
    """Whole-frame mode semantics: frames cycle decode
    slots 1..L-1 so slots get DIFFERENT sample counts; each slot's total must
    divide by its own count, not by a global num_times."""
    t = PhaseTimer(num_slots=3, num_times=4)
    # 4 frames cycling slots 1, 2, 1, 2 -- slot 1 gets 10ms+30ms, slot 2
    # gets 20ms+40ms; slot 0 (excluded by &decode[1] semantics) gets one.
    t.add("decode", 0, 99e-3)
    t.add("decode", 1, 10e-3)
    t.add("decode", 2, 20e-3)
    t.add("decode", 1, 30e-3)
    t.add("decode", 2, 40e-3)
    avg, var = t.summary()["decode"]
    # Hand-computed: slot means are 20ms and 30ms -> avg 25ms; variance of
    # means is 25e-6, scaled by the mean occurrence count (2) for
    # printTimes parity -> 50e-6.
    assert abs(avg - 25e-3) < 1e-12
    assert abs(var - 50e-6) < 1e-12
    # read phase: only slot 0 occupied; unoccupied slots are excluded
    # rather than dragging the mean toward zero.
    t.add("read", 0, 8e-3)
    t.add("read", 0, 4e-3)
    ravg, rvar = t.summary()["read"]
    assert abs(ravg - 6e-3) < 1e-12 and rvar == 0.0


def test_store_times_binary(tmp_path):
    from ofdm_ls_mrc_tpu.golden.io import load_times
    t = PhaseTimer(num_slots=2)
    t.add("read", 0, 1e-3); t.add("read", 1, 1e-3)
    t.add("chanest", 0, 2e-3)
    t.add("decode", 1, 3e-3)
    t.add("fft", 0, 4e-3); t.add("fft", 1, 4e-3)
    t.add("drop", 0, 5e-3); t.add("drop", 1, 5e-3)
    p = tmp_path / "time_gpu.dat"
    t.store_times(str(p))
    back = load_times(str(p))
    np.testing.assert_allclose(back, [1e-3, 2e-3, 3e-3, 4e-3, 5e-3], rtol=1e-5)
