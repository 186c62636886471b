"""Golden-oracle self-consistency tests.

These pin the NumPy oracle's semantics to the reference's conventions
(cpuLS.hpp): shift directions, DC-bin drop, division order, FFTW scaling.
Everything else in the framework is tested against this oracle.
"""

import numpy as np
import pytest

from ofdm_ls_mrc_tpu.golden import dsp, io as gio
from ofdm_ls_mrc_tpu.sim import ChannelModel, evm_db, make_tx_frame, random_symbols


def reference_memmove_pilot_shift(x):
    """Literal re-enactment of the three-memmove swap (cpuLS.hpp:105-113)."""
    x = x.copy()
    cols = x.size
    temp = x[(cols + 1) // 2:].copy()            # second half -> temp
    x[(cols - 1) // 2:] = x[: (cols + 1) // 2]   # first half -> second half
    x[: (cols - 1) // 2] = temp                  # temp -> first half
    return x


def reference_memmove_output_shift(x):
    """Literal re-enactment of shiftOneRow (cpuLS.hpp:135-149)."""
    x = x.copy()
    cols = x.size
    temp = x[(cols - 1) // 2: (cols - 1) // 2 + (cols + 1) // 2].copy()
    x[(cols + 1) // 2:] = x[: (cols - 1) // 2]
    x[: (cols + 1) // 2] = temp
    return x


class TestShiftConventions:
    def test_pilot_shift_is_fftshift_odd(self, rng):
        x = rng.standard_normal(1023).astype(np.complex64)
        np.testing.assert_array_equal(dsp.pilot_shift(x),
                                      reference_memmove_pilot_shift(x))
        np.testing.assert_array_equal(dsp.pilot_shift(x), np.fft.fftshift(x))

    def test_output_shift_is_ifftshift_odd(self, rng):
        x = rng.standard_normal(1023).astype(np.complex64)
        np.testing.assert_array_equal(dsp.output_shift(x),
                                      reference_memmove_output_shift(x))
        np.testing.assert_array_equal(dsp.output_shift(x), np.fft.ifftshift(x))

    def test_shifts_differ_for_odd_lengths(self, rng):
        x = rng.standard_normal(1023).astype(np.complex64)
        assert not np.array_equal(dsp.pilot_shift(x), dsp.output_shift(x))

    def test_output_shift_inverts_pilot_shift(self, rng):
        x = rng.standard_normal(1023).astype(np.complex64)
        np.testing.assert_array_equal(dsp.output_shift(dsp.pilot_shift(x)), x)


class TestChannelEstimation:
    def test_identity_channel_unit_pilot(self):
        """Pilot sent on bins 1..F-1 with X=1 -> H == 1, Hsqrd == A."""
        a, f = 4, 64
        x = np.ones(f - 1, dtype=np.complex64)
        grid = np.zeros((a, f), dtype=np.complex64)
        grid[:, 1:] = x
        td = np.fft.ifft(grid, axis=-1).astype(np.complex64)
        hconj, hsqrd = dsp.estimate_channel(td, x)
        np.testing.assert_allclose(hconj, np.ones((a, f - 1)), atol=1e-5)
        np.testing.assert_allclose(hsqrd, a * np.ones(f - 1), atol=1e-4)

    def test_known_flat_channel(self, rng):
        """Per-antenna complex gains are recovered exactly (flat channel)."""
        a, f = 8, 128
        gains = (rng.standard_normal(a) + 1j * rng.standard_normal(a)).astype(np.complex64)
        x = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
        grid = np.zeros((f,), dtype=np.complex64)
        grid[1:] = x
        td = np.fft.ifft(grid).astype(np.complex64)
        pilot_rx = gains[:, None] * td[None, :]
        hconj, hsqrd = dsp.estimate_channel(pilot_rx, x)
        np.testing.assert_allclose(hconj, np.conj(gains)[:, None] * np.ones((a, f - 1)),
                                   atol=1e-4)
        np.testing.assert_allclose(hsqrd, np.sum(np.abs(gains) ** 2) * np.ones(f - 1),
                                   rtol=1e-4)


class TestEndToEnd:
    @pytest.mark.parametrize("a,f,cp,snr", [(4, 64, 8, 100.0), (16, 256, 32, 30.0)])
    def test_loopback_evm(self, rng, a, f, cp, snr):
        """TX -> multipath channel -> golden demod recovers the data."""
        s = 11
        data, _ = random_symbols(rng, (s - 1, f - 1), "qpsk")
        pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
        frame = make_tx_frame(data, pilot, cp)
        chan = ChannelModel(num_antennas=a, fft_size=f, num_taps=min(cp, 4) or 1,
                            snr_db=snr, seed=1)
        rx = chan.apply(frame, cp)
        out = dsp.demod_frame(rx, pilot, cp)
        # Undo the reference's output ifftshift to compare against sent data.
        out_natural = np.fft.fftshift(out, axes=-1)
        assert evm_db(out_natural, data) < -20.0

    @pytest.mark.parametrize("scheme", ["qpsk", "16qam", "64qam"])
    def test_constellation_loopback_zero_ser(self, rng, scheme):
        """Every constellation has unit average power and survives a 30 dB
        multipath channel with zero symbol errors after hard demap."""
        from ofdm_ls_mrc_tpu.sim import CONSTELLATIONS, demap_symbols
        const = CONSTELLATIONS[scheme]
        assert np.mean(np.abs(const) ** 2) == pytest.approx(1.0, rel=1e-6)
        a, f, cp, s = 8, 128, 16, 9
        data, idx = random_symbols(rng, (s - 1, f - 1), scheme)
        pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
        rx = ChannelModel(num_antennas=a, fft_size=f, num_taps=4,
                          snr_db=30.0, seed=3).apply(make_tx_frame(data, pilot, cp), cp)
        out = np.fft.fftshift(dsp.demod_frame(rx, pilot, cp), axes=-1)
        got = demap_symbols(out, scheme)
        assert np.array_equal(got, idx % const.size)

    def test_demap_chunking_matches_and_keeps_shape(self, rng):
        """demap_symbols processes a flat chunked view (bounded memory for
        capture-file-sized inputs); results must be identical across chunk
        boundaries and preserve the input's N-D shape."""
        from ofdm_ls_mrc_tpu.sim import demap_symbols, map_symbols
        # > 1<<20/64 elements so the 64-QAM path spans several chunks.
        idx = rng.integers(0, 64, size=(40, 1023))
        syms = map_symbols(idx, "64qam") + (
            0.01 * (rng.standard_normal((40, 1023))
                    + 1j * rng.standard_normal((40, 1023)))).astype(np.complex64)
        got = demap_symbols(syms, "64qam")
        assert got.shape == idx.shape
        assert np.array_equal(got, idx)

    def test_noiseless_loopback_is_exact(self, rng):
        a, f, cp, s = 2, 64, 8, 5
        data, _ = random_symbols(rng, (s - 1, f - 1), "qpsk")
        pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
        frame = make_tx_frame(data, pilot, cp)
        chan = ChannelModel(num_antennas=a, fft_size=f, num_taps=4,
                            snr_db=300.0, seed=2)
        rx = chan.apply(frame, cp)
        out = np.fft.fftshift(dsp.demod_frame(rx, pilot, cp), axes=-1)
        np.testing.assert_allclose(out, data, atol=1e-3)


class TestModulator:
    def test_max_abs_normalized(self, rng):
        data = (rng.standard_normal(63) + 1j * rng.standard_normal(63)).astype(np.complex64)
        td = dsp.modulate_symbol(data, cp=8)
        assert td.shape == (72,)
        np.testing.assert_allclose(np.max(np.abs(td[8:])), 1.0, rtol=1e-5)

    def test_cyclic_prefix_is_tail(self, rng):
        data = (rng.standard_normal(63) + 1j * rng.standard_normal(63)).astype(np.complex64)
        td = dsp.modulate_symbol(data, cp=16)
        np.testing.assert_array_equal(td[:16], td[-16:])

    def test_unnormalized_ifft_matches_fftw_backward(self, rng):
        """FFTW_BACKWARD == np.fft.ifft * N: fft(modulated) recovers grid*F/max."""
        f = 64
        data = (rng.standard_normal(f - 1) + 1j * rng.standard_normal(f - 1)).astype(np.complex64)
        td = dsp.modulate_symbol(data, cp=0)
        spec = np.fft.fft(td)
        grid = np.zeros(f, dtype=np.complex64)
        grid[1:] = data
        expect = dsp.tx_shift(grid)
        # spec should be proportional to expect with a real positive scale.
        nz = np.abs(expect) > 1e-6
        ratios = spec[nz] / expect[nz]
        assert np.allclose(ratios, ratios[0], atol=1e-3)


class TestZeroForcing:
    def test_right_inverse(self, rng):
        s, u, a = 33, 4, 16
        h = (rng.standard_normal((s, u, a)) + 1j * rng.standard_normal((s, u, a))
             ).astype(np.complex64)
        w = dsp.zf_precoder(h)
        prod = np.einsum("sua,sav->suv", h, w)
        eye = np.broadcast_to(np.eye(u, dtype=np.complex64), (s, u, u))
        np.testing.assert_allclose(prod, eye, atol=1e-3)

    def test_zf_removes_interuser_interference(self, rng):
        s, u, a = 16, 4, 8
        h = (rng.standard_normal((s, u, a)) + 1j * rng.standard_normal((s, u, a))
             ).astype(np.complex64)
        x = (rng.standard_normal((u, s)) + 1j * rng.standard_normal((u, s))
             ).astype(np.complex64)
        w = dsp.zf_precoder(h)
        ant = dsp.apply_precoder(w, x)          # [A, S]
        rx = np.einsum("sua,as->us", h, ant)    # each user sees only own stream
        np.testing.assert_allclose(rx, x, atol=1e-3)

    def test_rot_cube_layout(self, rng):
        u, a, s = 4, 16, 7
        x = rng.standard_normal((u, a, s)).astype(np.complex64)
        r = dsp.rot_cube(x)
        assert r.shape == (s, a, u)
        assert r[3, 5, 2] == x[2, 5, 3]


class TestFileFormats:
    def test_pilot_roundtrip(self, tmp_path, rng):
        p = tmp_path / "Pilots.dat"
        raw = (rng.standard_normal(1023) + 1j * rng.standard_normal(1023)
               ).astype(np.complex64)
        gio.write_pilot(str(p), raw)
        loaded = gio.load_pilot(str(p))
        np.testing.assert_array_equal(loaded, np.fft.fftshift(raw))

    def test_pilot_fallback_fill(self, tmp_path):
        loaded = gio.load_pilot(str(tmp_path / "missing.dat"), 63)
        np.testing.assert_allclose(loaded, np.full(63, 0.707 + 0.707j), atol=1e-6)

    def test_output_roundtrip(self, tmp_path, rng):
        p = tmp_path / "Output_gpu.dat"
        syms = (rng.standard_normal((5, 63)) + 1j * rng.standard_normal((5, 63))
                ).astype(np.complex64)
        gio.append_output(str(p), syms[:2], truncate=True)
        gio.append_output(str(p), syms[2:])
        back = gio.read_output(str(p), 63)
        np.testing.assert_array_equal(back, syms)

    def test_times_roundtrip(self, tmp_path):
        p = tmp_path / "time_gpu.dat"
        gio.store_times(str(p), 1e-3, 2e-3, 3e-3, 4e-3, 5e-3)
        back = gio.load_times(str(p))
        np.testing.assert_allclose(back, [1e-3, 2e-3, 3e-3, 4e-3, 5e-3], rtol=1e-6)


class TestSc16Clipping:
    def test_clip_counted_and_warned_once(self, rng):
        import warnings

        from ofdm_ls_mrc_tpu.golden import io as gio

        before = gio.sc16_clipped_samples()
        hot = np.array([2.0 + 0.5j, -3.0 - 0.25j], np.complex64)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            gio.complex_to_sc16(hot)          # 2 components beyond full scale
            gio.complex_to_sc16(hot)          # counted, but not re-warned
        assert gio.sc16_clipped_samples() - before == 4
        assert sum("complex_to_sc16" in str(x.message) for x in w) <= 1

    def test_in_range_does_not_warn_or_count(self, rng):
        import warnings

        from ofdm_ls_mrc_tpu.golden import io as gio

        before = gio.sc16_clipped_samples()
        ok = (0.5 * (rng.standard_normal(64) + 1j * rng.standard_normal(64))
              ).astype(np.complex64)
        ok /= max(1.0, np.abs(ok.view(np.float32)).max())
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            gio.complex_to_sc16(ok)
        assert gio.sc16_clipped_samples() == before
        assert not any("complex_to_sc16" in str(x.message) for x in w)


def test_num_symbols_helper(tmp_path, rng):
    """golden.io.num_symbols == the reference's numSyms file sizing
    (cpuLS.hpp:176-184): bytes / (8 * symbol length)."""
    from ofdm_ls_mrc_tpu.golden.io import num_symbols

    p = tmp_path / "cap.dat"
    data = (rng.standard_normal(5 * 72) + 1j * rng.standard_normal(5 * 72)
            ).astype(np.complex64)
    data.tofile(p)
    assert num_symbols(str(p), 72) == 5
    assert num_symbols(str(p), 64, prefix=8) == 5
    assert num_symbols(str(p), 100) == 3   # truncating, like the reference
