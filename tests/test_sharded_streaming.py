"""Antenna-sharded per-symbol streaming (parallel/streaming.py).

The low-latency demodOneSymbol shape (gpuLS.cu:410-473) scaled over the
``ant`` mesh axis: the estimate stays sharded and device-resident, every
data symbol costs exactly one 2*F-word psum.  Must match the NumPy golden
and the unsharded StreamingDemodulator bit-for-bit in structure terms.
"""

import re

import jax
import numpy as np
import pytest

from ofdm_ls_mrc_tpu import FrameConfig
from ofdm_ls_mrc_tpu.golden import dsp
from ofdm_ls_mrc_tpu.parallel import ShardedStreamingDemodulator, make_mesh
from ofdm_ls_mrc_tpu.utils.timing import PhaseTimer

CFG = FrameConfig(num_antennas=8, fft_size=64, cyclic_prefix=8, frame_len=9)


def crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must force 8 virtual CPU devices"
    return devs


def _frame_and_pilot(rng):
    pilot = np.exp(2j * np.pi * rng.random(CFG.num_subcarriers)
                   ).astype(np.complex64)
    frame = crandn(rng, (CFG.frame_len, CFG.num_antennas, CFG.symbol_len))
    return frame, pilot


@pytest.mark.parametrize("pipeline", ["composed", "fast"])
@pytest.mark.parametrize("ant_shards", [2, 4, 8])
def test_matches_golden(rng, devices, pipeline, ant_shards):
    frame, pilot = _frame_and_pilot(rng)
    want = dsp.demod_frame(frame, pilot, CFG.cyclic_prefix)
    mesh = make_mesh(ant_shards, 1)
    sd = ShardedStreamingDemodulator(CFG, pilot, mesh, pipeline=pipeline,
                                     fft_impl="four_step")
    sd.push_pilot(frame[0])
    for i in range(1, CFG.frame_len):
        got = sd.push_symbol(frame[i]).to_numpy()
        np.testing.assert_allclose(got, want[i - 1], rtol=2e-3, atol=2e-3)


def test_fused_body_matches_golden(rng, devices):
    """The default per-symbol shard body (jnp.fft + XLA-fused local MRC
    numerator, one psum) at the reference 1024-point FFT."""
    cfg = FrameConfig(num_antennas=4, fft_size=1024, cyclic_prefix=8,
                      frame_len=3)
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)
                   ).astype(np.complex64)
    frame = crandn(rng, (cfg.frame_len, cfg.num_antennas, cfg.symbol_len))
    want = dsp.demod_frame(frame, pilot, cfg.cyclic_prefix)
    mesh = make_mesh(2, 1)
    sd = ShardedStreamingDemodulator(cfg, pilot, mesh)
    assert sd.pipeline == "composed"
    sd.push_pilot(frame[0])
    for i in range(1, cfg.frame_len):
        got = sd.push_symbol(frame[i]).to_numpy()
        err = np.max(np.abs(got - want[i - 1])) / np.max(np.abs(want[i - 1]))
        assert err < 5e-4, err


@pytest.mark.parametrize("pipeline", ["fast", "composed"])
def test_int16_shards_match_quantized_golden(rng, devices, pipeline):
    """sc16-native per-symbol shards: planar INT16 input widens on device
    per shard; output must match the NumPy golden on the quantized symbols
    (the sharded leg of the per-symbol sc16 feed)."""
    from ofdm_ls_mrc_tpu.golden.io import SC16_FULL_SCALE, complex_to_sc16
    from ofdm_ls_mrc_tpu.ops.cplx import CArray

    fft = 256 if pipeline == "composed" else 64
    cfg = FrameConfig(num_antennas=4, fft_size=fft, cyclic_prefix=0,
                      frame_len=3)
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)
                   ).astype(np.complex64)
    frame = crandn(rng, (cfg.frame_len, cfg.num_antennas, cfg.symbol_len)) * 0.05

    def planes(sym):
        s = complex_to_sc16(sym)
        re_p = np.ascontiguousarray(s[:, ::2])
        im_p = np.ascontiguousarray(s[:, 1::2])
        q = (re_p.astype(np.float32) + 1j * im_p.astype(np.float32)
             ).astype(np.complex64) / SC16_FULL_SCALE
        return CArray(re_p, im_p), q

    ps = [planes(s) for s in frame]
    want = dsp.demod_frame(np.stack([q for _, q in ps]), pilot, 0)
    mesh = make_mesh(2, 1)
    sd = ShardedStreamingDemodulator(cfg, pilot, mesh, pipeline=pipeline)
    assert sd.pipeline == pipeline
    sd.warmup(int16=True)
    sd.push_pilot(ps[0][0])
    for i in range(1, cfg.frame_len):
        got = sd.push_symbol(ps[i][0]).to_numpy()
        np.testing.assert_allclose(got, want[i - 1], rtol=3e-3, atol=3e-3)


def test_matches_unsharded_streaming(rng, devices):
    from ofdm_ls_mrc_tpu.models.streaming import StreamingDemodulator

    frame, pilot = _frame_and_pilot(rng)
    mesh = make_mesh(4, 1)
    sh = ShardedStreamingDemodulator(CFG, pilot, mesh, pipeline="composed",
                                     fft_impl="four_step")
    un = StreamingDemodulator(CFG, pilot, fft_impl="four_step")
    sh.push_pilot(frame[0])
    un.push_pilot(frame[0])
    for i in range(1, 4):
        a = sh.push_symbol(frame[i]).to_numpy()
        b = un.push_symbol(frame[i]).to_numpy()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_per_symbol_collective_structure(rng, devices):
    """Steady state: the per-symbol program carries EXACTLY ONE all-reduce
    of 2*F fp32 words (numerator re+im) -- smaller than the whole-frame
    path's (2*S+1)*F fused payload; |H|^2 reduces once, at pilot time."""
    frame, pilot = _frame_and_pilot(rng)
    mesh = make_mesh(4, 1)
    sd = ShardedStreamingDemodulator(CFG, pilot, mesh, pipeline="composed",
                                     fft_impl="four_step")
    sd.push_pilot(frame[0])
    c = sd._demod.lower(
        type(sd._hconj).from_numpy(frame[1]), sd._hconj, sd._hsqrd
    ).compile().as_text()
    ar = [ln for ln in c.splitlines() if re.search(r"=.*\ball-reduce\(", ln)]
    assert len(ar) == 1, ar
    words = sum(
        int(np.prod([int(d) for d in dims.split(",")]))
        for dims in re.findall(r"f32\[([0-9,]+)\]", ar[0].split("all-reduce(")[0]))
    assert words == 2 * CFG.fft_size


def test_requires_pilot_first_and_timer_slots(rng, devices):
    frame, pilot = _frame_and_pilot(rng)
    timer = PhaseTimer(CFG.frame_len)
    mesh = make_mesh(2, 1)
    sd = ShardedStreamingDemodulator(CFG, pilot, mesh, pipeline="composed",
                                     fft_impl="four_step", timer=timer)
    with pytest.raises(RuntimeError, match="push_pilot first"):
        sd.push_symbol(frame[1])
    sd.push_pilot(frame[0], slot=0)
    sd.push_symbol(frame[1], slot=1)
    assert timer.counts["chanest"][0] == 1
    assert timer.counts["decode"][1] == 1


def test_indivisible_antennas_rejected(rng, devices):
    _, pilot = _frame_and_pilot(rng)
    cfg = FrameConfig(num_antennas=6, fft_size=64, cyclic_prefix=8,
                      frame_len=9)
    pilot6 = pilot
    with pytest.raises(ValueError, match="not divisible"):
        ShardedStreamingDemodulator(cfg, pilot6, make_mesh(4, 1),
                                    pipeline="composed")


class TestSaveResumeInterop:
    """Checkpoints are written in the portable true-frequency layout, so
    they move between sharded and unsharded consumers and across
    pipelines (the io/state.py contract)."""

    def test_sharded_fast_roundtrip(self, rng, devices, tmp_path):
        frame, pilot = _frame_and_pilot(rng)
        mesh = make_mesh(4, 1)
        a = ShardedStreamingDemodulator(CFG, pilot, mesh, pipeline="fast")
        a.push_pilot(frame[0])
        want = a.push_symbol(frame[1]).to_numpy()
        p = str(tmp_path / "est.ckpt")
        a.save_state(p, frame_index=7)
        b = ShardedStreamingDemodulator(CFG, pilot, make_mesh(2, 1),
                                        pipeline="fast")
        assert b.resume(p) == 7
        got = b.push_symbol(frame[1]).to_numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_sharded_to_unsharded_and_back(self, rng, devices, tmp_path):
        from ofdm_ls_mrc_tpu.models.streaming import StreamingDemodulator

        frame, pilot = _frame_and_pilot(rng)
        sh = ShardedStreamingDemodulator(CFG, pilot, make_mesh(4, 1),
                                         pipeline="composed",
                                         fft_impl="four_step")
        sh.push_pilot(frame[0])
        want = sh.push_symbol(frame[1]).to_numpy()
        p = str(tmp_path / "est.ckpt")
        sh.save_state(p)

        un = StreamingDemodulator(CFG, pilot, fft_impl="four_step")
        un.resume(p)
        np.testing.assert_allclose(un.push_symbol(frame[1]).to_numpy(), want,
                                   rtol=1e-5, atol=1e-6)

        p2 = str(tmp_path / "est2.ckpt")
        un.save_state(p2)
        sh2 = ShardedStreamingDemodulator(CFG, pilot, make_mesh(2, 1),
                                          pipeline="fast")
        sh2.resume(p2)
        np.testing.assert_allclose(sh2.push_symbol(frame[1]).to_numpy(), want,
                                   rtol=1e-4, atol=1e-5)
