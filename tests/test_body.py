"""The one device path: body choice, sc16 widening, and the composed and
fast bodies against golden/dsp.py over the geometries the receiver serves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ofdm_ls_mrc_tpu import FrameConfig
from ofdm_ls_mrc_tpu.golden import dsp
from ofdm_ls_mrc_tpu.golden.io import SC16_FULL_SCALE
from ofdm_ls_mrc_tpu.models import StreamingDemodulator, UplinkReceiver
from ofdm_ls_mrc_tpu.models.body import choose_body
from ofdm_ls_mrc_tpu.ops.cplx import CArray
from ofdm_ls_mrc_tpu.ops.modulate import widen_sc16


def crandn(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def quantize(frame):
    """complex64 -> (re int16, im int16, the complex64 value they carry)."""
    re = np.round(frame.real * SC16_FULL_SCALE).astype(np.int16)
    im = np.round(frame.imag * SC16_FULL_SCALE).astype(np.int16)
    q = ((re.astype(np.float32) + 1j * im.astype(np.float32))
         / SC16_FULL_SCALE).astype(np.complex64)
    return re, im, q


# -- choose_body ---------------------------------------------------------------

@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_choose_body_defaults(platform):
    assert choose_body(platform=platform) == ("composed", "xla")


@pytest.mark.parametrize("pipeline,fft_impl,want", [
    ("composed", "xla", ("composed", "xla")),
    ("composed", "four_step", ("composed", "four_step")),
    ("fast", None, ("fast", "xla")),
    (None, "matmul", ("composed", "matmul")),
])
def test_choose_body_explicit(pipeline, fft_impl, want):
    assert choose_body(pipeline, fft_impl, platform="gpu") == want


@pytest.mark.parametrize("kw,match", [
    (dict(platform="rocm"), "no device path for platform"),
    (dict(platform="METAL"), "no device path for platform"),
    (dict(pipeline="fused", platform="gpu"), "unknown pipeline"),
    (dict(fft_impl="pallas", platform="cpu"), "unknown fft_impl"),
])
def test_choose_body_rejects(kw, match):
    """An unknown platform, body or FFT is an error, never a fallback."""
    with pytest.raises(ValueError, match=match):
        choose_body(**kw)


@pytest.mark.parametrize("receiver", ["uplink", "streaming",
                                      "sharded", "sharded_streaming"])
def test_receivers_refuse_unknown_platform(monkeypatch, rng, receiver):
    """Every receiver asks choose_body, so none runs on a platform without
    a tested device path (the backend is faked; nothing is traced)."""
    from ofdm_ls_mrc_tpu.parallel import (
        ShardedStreamingDemodulator,
        ShardedUplinkReceiver,
        make_mesh,
    )

    cfg = FrameConfig(num_antennas=2, fft_size=64, cyclic_prefix=0,
                      frame_len=3)
    pilot = np.exp(2j * np.pi * rng.random(63)).astype(np.complex64)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    build = {"uplink": lambda: UplinkReceiver(cfg, pilot),
             "streaming": lambda: StreamingDemodulator(cfg, pilot),
             "sharded": lambda: ShardedUplinkReceiver(cfg, pilot, mesh),
             "sharded_streaming": lambda: ShardedStreamingDemodulator(
                 cfg, pilot, mesh)}[receiver]
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(ValueError, match="no device path"):
        build()


# -- sc16 widening -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.int32])
def test_widen_sc16(dtype):
    x = np.array([[-32767, -1, 0, 1, 32767]], dtype=dtype)
    got = jax.jit(widen_sc16)(CArray(jnp.asarray(x), jnp.asarray(-x)))
    assert got.re.dtype == jnp.float32
    if np.issubdtype(dtype, np.integer):
        want = x.astype(np.float32) / SC16_FULL_SCALE
    else:
        want = x
    np.testing.assert_array_equal(np.asarray(got.re), want)
    np.testing.assert_array_equal(np.asarray(got.im), -want)


def test_split_phase_sc16_matches_whole_frame(rng):
    """estimate_channel / demod_data widen int16 too: the split-phase API on
    sc16 planes equals the whole-frame result on the same quantized frame."""
    cfg = FrameConfig(num_antennas=4, fft_size=256, cyclic_prefix=0,
                      frame_len=5)
    pilot = np.exp(2j * np.pi * rng.random(255)).astype(np.complex64)
    re, im, q = quantize(crandn(rng, (5, 4, 256), 0.1))
    rx = UplinkReceiver(cfg, pilot)
    whole = rx.demod_frame(q).to_numpy()
    h = rx.estimate_channel(CArray(jnp.asarray(re[0]), jnp.asarray(im[0])))
    split = rx.demod_data(CArray(jnp.asarray(re[1:]), jnp.asarray(im[1:])),
                          *h).to_numpy()
    np.testing.assert_allclose(split, whole, rtol=1e-5, atol=1e-5)


# -- the bodies against the golden over the served geometries ------------------

GEOMETRIES = [  # (antennas, symbols, cp, fft, input)
    (4, 9, 72, 1024, "f32"),
    (4, 17, 0, 1024, "f32"),
    (1, 2, 0, 1024, "f32"),
    (1, 9, 72, 1024, "f32"),
    (3, 2, 16, 1024, "f32"),
    (2, 6, 32, 256, "f32"),
    (2, 6, 32, 512, "f32"),
    (2, 6, 32, 2048, "f32"),
    (16, 9, 0, 1024, "f32"),
    (64, 3, 0, 1024, "f32"),
    (4, 9, 0, 1024, "sc16"),
    (16, 5, 72, 1024, "sc16"),
    (5, 7, 8, 384, "sc16"),
]


@pytest.mark.parametrize("pipeline", ["composed", "fast"])
@pytest.mark.parametrize("a,s,cp,f,inp", GEOMETRIES,
                         ids=[f"{a}x{f}x{s}-cp{cp}-{inp}"
                              for a, s, cp, f, inp in GEOMETRIES])
def test_body_matches_golden(rng, pipeline, a, s, cp, f, inp):
    cfg = FrameConfig(num_antennas=a, fft_size=f, cyclic_prefix=cp,
                      frame_len=s)
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    frame = crandn(rng, (s, a, f + cp), 0.1)
    rx = UplinkReceiver(cfg, pilot, pipeline=pipeline)
    if inp == "sc16":
        re, im, frame = quantize(frame)
        got = rx.demod_frame(CArray(jnp.asarray(re), jnp.asarray(im)))
    else:
        got = rx.demod_frame(frame)
    want = dsp.demod_frame(frame, pilot, cp)
    got = got.to_numpy()
    assert got.shape == (s - 1, f - 1)
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    # fp32-grade; one antenna has no diversity, so bins where |H|^2 nears
    # zero amplify the FFT's rounding (the golden runs the same division).
    assert err < (5e-5 if a > 1 else 3e-4), err
