"""The formats of the port beyond the serving ones against the JAX package
on the CPU, all in fp32: the MCLT and the MDCT's padding and window
options, ``raw``, ``mdct``, ``mdct_psd`` (its P2M pair) and
``ms_mdct_dual_v1``, the spectrogram's mel and ln-freqs, ``MelCascade``,
and the format registry.

Bounds are relative L2 errors (|got - want| / |want| over the whole
tensor): 1e-5 for the linear transforms (the MDCT and MCLT bases are the
same float64-built constants; products and FFTs differ by fp32 rounding),
1e-4 where a power or a pseudoinverse follows an FFT.

<-> dualdiffusion_tpu/ops/mdct.py, models/formats/, models/mel_cascade.py.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.models import formats as jformats
from dualdiffusion_tpu.models.mel_cascade import MelCascade as JaxMelCascade
from dualdiffusion_tpu.pipelines import pipeline as jpipeline
from dualdiffusion_tpu_torch.models import formats as tformats
from dualdiffusion_tpu_torch.models.mel_cascade import MelCascade
from dualdiffusion_tpu_torch.pipelines import pipeline as tpipeline

LINEAR, NONLINEAR = 1e-5, 1e-4
# the modules (the packages' ``ops`` export the functions under these names)
jmdct = importlib.import_module("dualdiffusion_tpu.ops.mdct")
tmdct = importlib.import_module("dualdiffusion_tpu_torch.ops.mdct")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _audio(t=16384, b=2, seed=0):
    rng = np.random.default_rng(seed)
    n = np.arange(t) / 32000.0
    tone = sum(0.1 * np.sin(2 * np.pi * f * n) for f in (55.0, 440.0, 3000.0))
    return (tone + 0.05 * rng.standard_normal((b, 2, t))).astype(np.float32)


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _pair(name, **cfg):
    jcls, jcfg = jformats.get_format_class(name)
    tcls, tcfg = tformats.get_format_class(name)
    return jcls(jcfg(**cfg)), tcls(tcfg(**cfg))


def _theta(b):
    """JAX's random phase angles for PRNGKey(0), as its formats draw them."""
    return np.array(jax.random.uniform(jax.random.PRNGKey(0), (b,)) * 2 * jnp.pi)


# ---------------------------------------------------------------------------
# ops/mdct.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,exponent", [("hann", 1.0), ("kaiser_bessel_derived", 1.0),
                                             ("blackman_harris", 17.0), ("sin", 0.0)])
def test_mclt_and_imclt_match_jax(window, exponent):
    x = _audio(5000)
    jr, ji = jmdct.mclt(jnp.asarray(x), 512, window_fn=window, window_exponent=exponent)
    tr, ti = tmdct.mclt(torch.from_numpy(x), 512, window_fn=window, window_exponent=exponent)
    assert _rel_l2(tr, jr) <= LINEAR and _rel_l2(ti, ji) <= LINEAR
    want = jmdct.imclt(jr, ji, 512, window_fn=window, window_exponent=exponent)
    got = tmdct.imclt(tr, ti, 512, window_fn=window, window_exponent=exponent)
    assert _rel_l2(got, want) <= LINEAR


@pytest.mark.parametrize("padding", [True, False])
@pytest.mark.parametrize("window,kwargs", [("sin_mdct", None),
                                           ("kaiser_bessel_derived", {"beta": 8.0})])
def test_mdct_padding_and_window_kwargs_match_jax(window, kwargs, padding):
    x = _audio(4096)
    jre, jim = jmdct.mdct(jnp.asarray(x), 256, window_fn=window, window_kwargs=kwargs,
                          padding=padding, return_complex=True)
    tre, tim = tmdct.mdct(torch.from_numpy(x), 256, window_fn=window, window_kwargs=kwargs,
                          padding=padding, return_complex=True)
    assert _rel_l2(tre, jre) <= LINEAR and _rel_l2(tim, jim) <= LINEAR
    want = jmdct.imdct(jre, 256, window_fn=window, window_kwargs=kwargs, padding=padding)
    got = tmdct.imdct(tre, 256, window_fn=window, window_kwargs=kwargs, padding=padding)
    assert _rel_l2(got, want) <= LINEAR


# ---------------------------------------------------------------------------
# the formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dual", [False, True])
def test_raw_format_matches_jax(dual):
    jf, tf = _pair("raw", dual_channel=dual)
    for length in (None, 100000):
        assert tf.get_raw_crop_width(length) == jf.get_raw_crop_width(length)
        assert tf.get_sample_shape(3, length) == jf.get_sample_shape(3, length)
    x = _audio(8192)
    want = jf.raw_to_sample(jnp.asarray(x), random_phase_augmentation=True,
                            key=jax.random.PRNGKey(0))
    got = tf.raw_to_sample(torch.from_numpy(x), theta=torch.from_numpy(_theta(2)))
    assert _rel_l2(got, want) <= LINEAR
    plain = tf.raw_to_sample(torch.from_numpy(x))
    assert _rel_l2(plain, jf.raw_to_sample(jnp.asarray(x))) <= LINEAR
    back = tf.sample_to_raw(plain)
    assert _rel_l2(back, jf.sample_to_raw(jnp.asarray(plain.numpy()))) <= LINEAR


@pytest.mark.parametrize("dual", [False, True])
def test_mdct_format_matches_jax(dual):
    jf, tf = _pair("mdct")
    for length in (None, 200000):
        assert tf.get_raw_crop_width(length) == jf.get_raw_crop_width(length)
        assert tf.get_sample_shape(2, length) == jf.get_sample_shape(2, length)
    x = _audio(8192)
    want = jf.raw_to_mdct(jnp.asarray(x), random_phase_augmentation=True, dual_channel=dual,
                          key=jax.random.PRNGKey(0))
    got = tf.raw_to_mdct(torch.from_numpy(x), theta=torch.from_numpy(_theta(2)),
                         dual_channel=dual)
    assert _rel_l2(got, want) <= LINEAR
    coeffs = tf.raw_to_mdct(torch.from_numpy(x))
    raw = tf.mdct_to_raw(coeffs)
    assert _rel_l2(raw, jf.mdct_to_raw(jnp.asarray(coeffs.numpy()))) <= LINEAR
    assert _rel_l2(raw[..., :8192], x) <= 1e-5
    assert _rel_l2(tf.raw_to_mdct_psd(torch.from_numpy(x)),
                   jf.raw_to_mdct_psd(jnp.asarray(x))) <= LINEAR


def test_mdct_psd_format_matches_jax():
    jf, tf = _pair("mdct_psd")
    assert tf.get_sample_shape(2, 300000) == jf.get_sample_shape(2, 300000)
    assert tf.get_raw_crop_width() == jf.get_raw_crop_width()
    x = _audio(8192)
    want = jf.raw_to_mdct(jnp.asarray(x), random_phase_augmentation=True,
                          key=jax.random.PRNGKey(0))
    got = tf.raw_to_mdct(torch.from_numpy(x), theta=torch.from_numpy(_theta(2)))
    assert _rel_l2(got, want) <= LINEAR
    coeffs = tf.raw_to_mdct(torch.from_numpy(x))
    jcoeffs = jnp.asarray(coeffs.numpy())
    assert _rel_l2(tf.mdct_to_raw(coeffs), jf.mdct_to_raw(jcoeffs)) <= LINEAR
    psd = tf.raw_to_mdct_psd(torch.from_numpy(x))
    assert _rel_l2(psd, jf.raw_to_mdct_psd(jnp.asarray(x))) <= LINEAR
    jpsd = jnp.asarray(psd.numpy())
    assert _rel_l2(tf.scale_mdct_from_psd(coeffs, psd), jf.scale_mdct_from_psd(jcoeffs, jpsd)) \
        <= LINEAR
    assert _rel_l2(tf.unscale_mdct_from_psd(coeffs, psd),
                   jf.unscale_mdct_from_psd(jcoeffs, jpsd)) <= LINEAR
    # the P2M pair on a grid whose sides are whole blocks
    grid = coeffs[:, :64, :32]
    p2m = tf.mdct_to_p2m(grid)
    assert _rel_l2(p2m, jf.mdct_to_p2m(jnp.asarray(grid.numpy()))) <= LINEAR
    back = tf.p2m_to_mdct(p2m)
    assert _rel_l2(back, jf.p2m_to_mdct(jnp.asarray(p2m.numpy()))) <= LINEAR


@pytest.mark.parametrize("cfg", [{}, {"mdct_dual_channel": True, "ms_freq_min": 30.0,
                                      "mdct_psd_num_bins": 1024},
                                 {"ms_window_func": "hann", "ms_window_exponent_high": None,
                                  "ms_abs_exponent": 0.25, "mdct_window_func": "sin"}])
def test_ms_mdct_dual_v1_matches_jax(cfg):
    jf, tf = _pair("ms_mdct_dual_v1", **cfg)
    for length in (None, 100000):
        assert tf.get_mel_spec_shape(2, length) == jf.get_mel_spec_shape(2, length)
        assert tf.get_mdct_shape(2, length) == jf.get_mdct_shape(2, length)
        assert tf.get_raw_crop_width(length) == jf.get_raw_crop_width(length)
    x = _audio(16384)
    mel = tf.raw_to_mel_spec(torch.from_numpy(x))
    assert _rel_l2(mel, jf.raw_to_mel_spec(jnp.asarray(x))) <= NONLINEAR
    assert _rel_l2(tf.mel_spec_to_mdct_psd(mel),
                   jf.mel_spec_to_mdct_psd(jnp.asarray(mel.numpy()))) <= NONLINEAR
    want = jf.raw_to_mdct(jnp.asarray(x), random_phase_augmentation=True,
                          key=jax.random.PRNGKey(0))
    got = tf.raw_to_mdct(torch.from_numpy(x), theta=torch.from_numpy(_theta(2)))
    assert _rel_l2(got, want) <= LINEAR
    coeffs = tf.raw_to_mdct(torch.from_numpy(x))
    raw = tf.mdct_to_raw(coeffs)
    assert _rel_l2(raw, jf.mdct_to_raw(jnp.asarray(coeffs.numpy()))) <= LINEAR
    assert _rel_l2(tf.raw_to_mdct_psd(torch.from_numpy(x)),
                   jf.raw_to_mdct_psd(jnp.asarray(x))) <= LINEAR


def test_spectrogram_mel_and_ln_freqs_match_jax():
    cfg = dict(num_frequencies=64, window_duration_ms=64, padded_duration_ms=64)
    jf, tf = _pair("spectrogram", **cfg)
    x = _audio(8192)
    mel = tf.raw_to_mel_spec(torch.from_numpy(x))
    assert _rel_l2(mel, jf.raw_to_mel_spec(jnp.asarray(x))) <= NONLINEAR
    c = tf.config
    assert torch.allclose(tf.raw_to_sample(torch.from_numpy(x)),
                          (mel - c.sample_mean) * c.raw_to_sample_scale)
    lf = tf.get_ln_freqs()
    assert lf.shape == (64,) and lf.dtype == torch.float32
    np.testing.assert_allclose(lf.numpy(), np.asarray(jf.get_ln_freqs()), rtol=1e-6, atol=1e-6)


def test_mel_cascade_matches_jax():
    x = np.random.default_rng(4).uniform(size=(2, 2, 256, 40)).astype(np.float32)
    jm, tm = JaxMelCascade(), MelCascade()
    y = tm(torch.from_numpy(x))
    assert y.shape == (2, 2, 32, 40)
    assert _rel_l2(y, jm(jnp.asarray(x))) <= LINEAR
    assert _rel_l2(tm.inverse_transform(y), jm.inverse_transform(jnp.asarray(y.numpy()))) \
        <= LINEAR
    for stage in (0, 2):
        xs = x[:, :, : 256 // 2 ** stage]
        assert _rel_l2(tm(torch.from_numpy(xs), stage), jm(jnp.asarray(xs), stage)) <= LINEAR


def test_format_registry_matches_jax():
    """Every format name of JAX's registry resolves in the port, to a config
    with the same fields and defaults, and the port's module registry holds
    the same ``format:`` keys as JAX's."""
    jreg = jformats.format._FORMAT_REGISTRY
    assert sorted(tformats.format._FORMAT_REGISTRY) == sorted(jreg)
    for name in jreg:
        tcls, tcfg = tformats.get_format_class(name)
        jcfg = jformats.get_format_class(name)[1]
        assert tcls.format_name == name
        assert {f.name: f.default for f in dataclasses.fields(tcfg)} == \
            {f.name: f.default for f in dataclasses.fields(jcfg)}
    with pytest.raises(KeyError):
        tformats.get_format_class("nope")
    jkeys = {k for k in jpipeline._MODULE_REGISTRY if k.startswith("format:")}
    assert {k for k in tpipeline.MODULE_REGISTRY if k.startswith("format:")} == jkeys
