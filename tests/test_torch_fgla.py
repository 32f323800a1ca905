"""Spectrogram DSP of the port against the JAX package on the CPU: STFT,
the mel filterbank, SPSI phases and Griffin-Lim (the kernel loop, run here
through K2/K3's plain versions, and the plain reference loop)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.ops import get_window
from dualdiffusion_tpu.ops.fgla import griffinlim as jax_griffinlim
from dualdiffusion_tpu.ops.fgla import spsi_phase as jax_spsi
from dualdiffusion_tpu.ops.mel import FrequencyScale as JaxFrequencyScale
from dualdiffusion_tpu.ops.stft import istft as jax_istft
from dualdiffusion_tpu.ops.stft import stft as jax_stft
from dualdiffusion_tpu_torch.ops import (FrequencyScale, griffinlim, griffinlim_reference,
                                         istft, spsi_phase, stft)

N_FFT, HOP, FRAMES = 1280, 256, 41


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _signal(seed=7):
    """Stereo tones + chirp + a little noise, (1, 2, (FRAMES-1)*HOP)."""
    rng = np.random.default_rng(seed)
    t = np.arange((FRAMES - 1) * HOP) / 32000
    sig = sum(0.2 * np.sin(2 * np.pi * f * t) for f in (220.0, 473.0, 881.0))
    sig = sig + 0.1 * np.sin(2 * np.pi * (200 + 40 * t) * t)
    sig = sig + 0.02 * rng.standard_normal(sig.shape)
    return np.stack([sig, 0.8 * sig]).astype(np.float32)[None]


WIN = get_window("hann_power", N_FFT, exponent=8.0)


def _mag():
    return np.abs(np.asarray(jax_stft(jnp.asarray(_signal()), WIN, N_FFT, HOP, backend="fft")))


def test_stft_istft_match_jax():
    """fp32 transforms of the same framing: 1e-5 of max."""
    sig = _signal()
    want = np.array(jax_stft(jnp.asarray(sig), WIN, N_FFT, HOP, backend="fft"))
    got = stft(torch.from_numpy(sig), WIN, N_FFT, HOP).numpy()
    assert _rel_err(got.real, want.real) < 1e-5 and _rel_err(got.imag, want.imag) < 1e-5
    back_want = np.asarray(jax_istft(jnp.asarray(want), WIN, N_FFT, HOP, backend="fft"))
    back = istft(torch.from_numpy(want), WIN, N_FFT, HOP).numpy()
    assert _rel_err(back, back_want) < 1e-5
    assert _rel_err(back, sig) < 1e-4          # and it inverts


def test_mel_scale_unscale_match_jax():
    """Same filterbank and pseudoinverse (built by the same numpy code);
    fp32 matmuls agree to 1e-5 of max."""
    kw = dict(freq_scale="mel", freq_min=20.0, freq_max=16000.0, sample_rate=32000,
              num_stft_bins=N_FFT // 2 + 1, num_filters=64)
    jfs, tfs = JaxFrequencyScale(**kw), FrequencyScale(**kw)
    mag = np.swapaxes(_mag(), -1, -2).copy()
    mel = np.array(jfs.scale(jnp.asarray(mag)))
    assert _rel_err(tfs.scale(torch.from_numpy(mag)).numpy(), mel) < 1e-5
    assert _rel_err(tfs.unscale(torch.from_numpy(mel)).numpy(),
                    np.asarray(jfs.unscale(jnp.asarray(mel)))) < 1e-5


def test_spsi_phase_matches_jax():
    """Phases integrate over frames in fp32, so compare unit phasors; a
    cumulative sum in another order leaves ~1e-3 rad."""
    mag = _mag()
    want = np.asarray(jax_spsi(jnp.asarray(mag), N_FFT, HOP))
    got = spsi_phase(torch.from_numpy(mag), N_FFT, HOP).numpy()
    assert np.abs(np.exp(1j * got) - np.exp(1j * want)).max() < 1e-2


@pytest.mark.parametrize("loop", [griffinlim, griffinlim_reference])
@pytest.mark.parametrize("phase_init,n_iter", [("spsi", 5), ("flat", 1)])
def test_griffinlim_matches_jax(loop, phase_init, n_iter):
    """Same iterations as JAX ops/fgla.griffinlim (fp32). With SPSI phases
    the runs stay 1e-3 of max apart over 5 iterations; flat phases land on
    near-cancelling bins whose phase is set by rounding noise, so (as the
    JAX package's own parity tests do) flat runs are compared sample-wise
    after one iteration (2e-2) and by spectral convergence below."""
    mag = _mag()
    want = np.asarray(jax_griffinlim(jnp.asarray(mag), WIN, N_FFT, HOP, n_iter=n_iter,
                                     work_dtype="float32", backend="fft",
                                     phase_init=phase_init))
    got = loop(torch.from_numpy(mag), WIN, N_FFT, HOP, n_iter=n_iter, work_dtype="float32",
               phase_init=phase_init).numpy()
    assert _rel_err(got, want) < (1e-3 if phase_init == "spsi" else 2e-2)


@pytest.mark.parametrize("work_dtype", ["float32", "bfloat16"])
def test_griffinlim_converges_like_jax(work_dtype):
    """Spectral convergence error ||  |stft(out)| - mag || / ||mag|| after 20
    flat-init iterations: the kernel loop within 5% of JAX's, in both work
    dtypes (bf16 state is self-correcting)."""
    mag = _mag()

    def conv_err(audio):
        m2 = np.abs(np.asarray(jax_stft(jnp.asarray(audio), WIN, N_FFT, HOP, backend="fft")))
        return np.linalg.norm(m2 - mag) / np.linalg.norm(mag)

    want = conv_err(np.asarray(jax_griffinlim(jnp.asarray(mag), WIN, N_FFT, HOP, n_iter=20,
                                              work_dtype=work_dtype, backend="fft")))
    got = conv_err(griffinlim(torch.from_numpy(mag), WIN, N_FFT, HOP, n_iter=20,
                              work_dtype=work_dtype).numpy())
    assert got < 1.05 * want, (got, want)
