"""The port's sampling entry point, ``python -m dualdiffusion_tpu_torch.sample``,
and the audio io it writes through: every option on a tiny model on the CPU
(a WAV at -20 LUFS), the ``--inpaint`` mask against the JAX ``sample.py``'s
inline computation, the refusals (no card without ``--device cpu``; ``--tp``
with fewer cards than ranks), ``--interactive`` handing over to the web UI,
and loudness normalization and the FLAC gate against the JAX package's
``utils/utils.py``.
"""

import logging

import numpy as np
import pytest
import torch

from dualdiffusion_tpu.pipelines.pipeline import Pipeline as JaxPipeline
from dualdiffusion_tpu.utils import utils as jax_utils
from dualdiffusion_tpu_torch import sample
from dualdiffusion_tpu_torch.models import DAE, DAEConfig, UNet, UNetConfig
from dualdiffusion_tpu_torch.models.convert import convert_unet_to_inpainting
from dualdiffusion_tpu_torch.models.formats import SpectrogramFormat, SpectrogramFormatConfig
from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
from dualdiffusion_tpu_torch.training import ema
from dualdiffusion_tpu_torch.training.ema import save_ema_archive
from dualdiffusion_tpu_torch.utils import (get_audio_loudness, load_audio, normalize_lufs,
                                           save_audio)

SR = 32000


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _signals():
    t = np.arange(SR * 2) / SR
    rng = np.random.default_rng(0)
    return {"sine": np.stack([0.3 * np.sin(2 * np.pi * 440 * t),
                              0.1 * np.sin(2 * np.pi * 1000 * t)]).astype(np.float32),
            "noise": (0.05 * rng.standard_normal((2, SR * 2))).astype(np.float32)}


@pytest.mark.parametrize("kind", ["sine", "noise"])
def test_loudness_matches_jax(kind):
    """BS.1770-4 integrated loudness and the normalization to -20 LUFS: the
    same numpy on both sides (1e-9 LU; the gained audio to 1e-6 of max),
    and the result reads -20 LUFS (0.01 LU)."""
    audio = _signals()[kind]
    got, want = get_audio_loudness(audio, SR), jax_utils.get_audio_loudness(audio, SR)
    assert abs(got - want) <= 1e-9
    out = normalize_lufs(audio, SR, -20.0)
    np.testing.assert_allclose(out, jax_utils.normalize_lufs(audio, SR, -20.0), rtol=1e-6,
                               atol=1e-7)
    assert abs(get_audio_loudness(out, SR) + 20.0) <= 0.01
    loud = normalize_lufs(audio, SR, 0.0)      # a peak over 1.15 is scaled down to it
    assert np.abs(loud).max() <= 1.15 + 1e-6
    assert get_audio_loudness(np.zeros((2, SR), np.float32), SR) == -70.0


def test_flac_gate_without_a_binary(tmp_path, monkeypatch, caplog):
    """With neither ``flac`` nor ``ffmpeg`` on PATH, loading a FLAC raises
    and saving one writes a WAV beside it with a warning, as in the JAX
    package (the same bytes); WAVs round-trip with their sample rate."""
    monkeypatch.setenv("PATH", "")
    audio = _signals()["sine"]
    with pytest.raises(RuntimeError, match="flac"):
        load_audio(tmp_path / "in.flac")
    with caplog.at_level(logging.WARNING):
        save_audio(audio, SR, tmp_path / "port" / "out.flac")
    assert "no flac encoder" in caplog.text
    jax_utils.save_audio(audio, SR, tmp_path / "jax" / "out.flac")
    assert not (tmp_path / "port" / "out.flac").exists()
    assert (tmp_path / "port" / "out.wav").read_bytes() == \
        (tmp_path / "jax" / "out.wav").read_bytes()
    back, sr = load_audio(tmp_path / "port" / "out.wav", return_sample_rate=True)
    assert sr == SR and back.shape == audio.shape
    assert np.abs(back - audio).max() <= 2 / 32767     # 16-bit truncation
    with pytest.raises(ValueError):
        load_audio(tmp_path / "x.mp3")


def _model_dir(tmp_path):
    """A tiny model (UNet with label embeddings, DAE, 128-frame spectrogram),
    its prompt embeddings, three bf16 EMA archives in ``unet/ema_archive/``
    and its inpainting UNet; plus a 1 s input WAV."""
    g = torch.Generator().manual_seed(0)
    ucfg = UNetConfig(in_channels=8, out_channels=8, in_channels_emb=16, model_channels=16,
                      channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=16,
                      logvar_channels=32, mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
    dcfg = DAEConfig(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
                     num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8)
    fcfg = SpectrogramFormatConfig(window_duration_ms=40, padded_duration_ms=40,
                                   num_frequencies=64, default_raw_length=127 * 256)
    unet = UNet(ucfg).init_weights(g)
    with torch.no_grad():
        unet.core.out_gain.fill_(1.0)
    rng = np.random.default_rng(1)
    emb = {"label_a_audio": rng.standard_normal(16).astype(np.float32),
           "_unconditional_audio": rng.standard_normal(16).astype(np.float32)}
    d = tmp_path / "model"
    Pipeline({"unet": ModuleHandle("unet", "unet", ucfg, unet),
              "dae": ModuleHandle("dae", "dae", dcfg, DAE(dcfg).init_weights(g)),
              "format": ModuleHandle("format", "format:spectrogram", fcfg,
                                     SpectrogramFormat(fcfg))},
             dataset_embeddings=emb).save_pretrained(d)
    for i, (n, std) in enumerate(((800, 0.05), (1600, 0.05), (1600, 0.1))):
        state = {k: v + 0.01 * torch.randn(v.shape, generator=g)
                 for k, v in unet.state_dict().items()}
        save_ema_archive(state, d / "unet" / "ema_archive" / f"{i}.safetensors", i, n, std)
    convert_unet_to_inpainting(d)
    wav = tmp_path / "in.wav"
    save_audio(0.2 * rng.standard_normal((2, SR)).astype(np.float32), SR, wav)
    return d, wav


def test_sample_cli_runs_every_option_on_the_cpu(tmp_path, monkeypatch):
    """``--prompt label_a:1.0 --load_ema phema_0.05 --img2img <wav>
    --img2img_strength 0.6 --inpaint 0.2:0.6 --seamless_loop`` on the CPU:
    the post-hoc EMA is reconstructed, the inpainting UNet runs every step,
    and the WAV written holds the crossfaded loop at -20 LUFS (0.5 LU)."""
    d, wav = _model_dir(tmp_path)
    steps, stds = [], []
    real, real_phema = Pipeline.diffusion_decode, ema.reconstruct_phema

    def spy(self, params, *a, **k):
        steps.append((params.steps, params.img2img_strength,
                      k.get("inpainting_mask") is not None))
        return real(self, params, *a, **k)
    monkeypatch.setattr(Pipeline, "diffusion_decode", spy)
    monkeypatch.setattr(ema, "reconstruct_phema",
                        lambda std, path: stds.append(std) or real_phema(std, path))
    out = tmp_path / "out" / "clip.wav"
    sample.main(["--model_path", str(d), "--prompt", "label_a:1.0", "--load_ema", "phema_0.05",
                 "--img2img", str(wav), "--img2img_strength", "0.6", "--inpaint", "0.2:0.6",
                 "--seamless_loop", "--steps", "2", "--num_fgla_iters", "2", "--seed", "3",
                 "--output", str(out), "--device", "cpu"])
    assert steps == [(2, 1.0, True)] and stds == [0.05]
    audio, sr = load_audio(out, return_sample_rate=True)
    assert sr == SR and audio.shape == (2, 127 * 256 - int(31.5 * 256) * 2)
    assert abs(get_audio_loudness(audio, SR) + 20.0) <= 0.5


def test_inpaint_mask_matches_sample_py(tmp_path):
    """``inpainting_mask`` against the inline computation of the JAX
    ``sample.py`` (lines 107-120, copied below) on the JAX package's load of
    the same directory."""
    d, _ = _model_dir(tmp_path)
    pipe = Pipeline.from_pretrained(d, device="cpu")
    pipeline = JaxPipeline.from_pretrained(d)
    for args_inpaint, length in (("0.2:0.6", None), ("0:10", None), ("0.5:0.51", None),
                                 ("-1:0.3", 64000)):
        sr = SR
        # --- sample.py:107-120 ---
        start_s, _, end_s = args_inpaint.partition(":")
        fmt = pipeline.format
        mel_shape = fmt.get_sample_shape(1, length)
        ds = (pipeline.modules["dae"].module.downsample_ratio
              if "dae" in pipeline.modules else 1)
        lat_w = mel_shape[2] // ds * ds // ds if ds > 1 else mel_shape[2]
        hop_s = getattr(fmt.config, "ms_hop_length",
                        getattr(fmt.config, "hop_length", 256)) * ds
        mask = np.zeros((1, 1, lat_w, 1), np.float32)
        c0 = int(float(start_s) * sr / hop_s)
        c1 = int(float(end_s) * sr / hop_s)
        mask[:, :, max(c0, 0):min(c1, lat_w)] = 1.0
        # ---
        got = sample.inpainting_mask(pipe, float(start_s), float(end_s), SR, length)
        np.testing.assert_array_equal(got, mask)
    assert sample.parse_prompt(["a:0.5", "b", "c:d:2"]) == {"a": 0.5, "b": 1.0, "c:d": 2.0}


def test_sample_cli_refuses_what_it_does_not_take(tmp_path, monkeypatch):
    """Without a card ``--device cuda`` (the default) raises instead of
    sampling on the CPU; ``--tp 2`` with fewer than two cards visible raises
    before anything loads, rather than sampling on fewer."""
    with pytest.raises(RuntimeError, match="needs 2 cards"):
        sample.main(["--model_path", str(tmp_path / "nowhere"), "--tp", "2"])
    d, _ = _model_dir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample.main(["--model_path", str(d), "--steps", "1", "--output",
                     str(tmp_path / "x.wav")])
    assert not (tmp_path / "x.wav").exists()


@pytest.mark.parametrize("device,port", [(None, None), ("cpu", None), (None, 8123)])
def test_interactive_starts_the_web_ui(tmp_path, monkeypatch, device, port):
    """``--interactive`` hands the model path, ``--port`` (8080 by default)
    and ``--device`` (cuda by default) to the web UI's ``run_app`` and
    samples nothing itself, as JAX ``sample.py:68-71`` does."""
    from dualdiffusion_tpu_torch.serving import webui
    calls = []
    monkeypatch.setattr(webui, "run_app", lambda *a, **kw: calls.append((a, kw)))
    flags = ["--interactive", "--output", str(tmp_path / "x.wav")]
    sample.main(["--model_path", str(tmp_path / "m")] + flags
                + ([] if device is None else ["--device", device])
                + ([] if port is None else ["--port", str(port)]))
    assert calls == [((str(tmp_path / "m"),), {"port": port or 8080, "device": device or "cuda"})]
    assert not (tmp_path / "x.wav").exists()
