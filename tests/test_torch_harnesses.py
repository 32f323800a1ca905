"""The port's component harnesses (``python -m
dualdiffusion_tpu_torch.scripts.<name>``) on the CPU against the JAX
package's root scripts on the same seeded input and the same tiny model
directory (written by the JAX package, read by both), and the dataset
factory's encode stage with a spectrogram-format DAE against JAX's.

<-> scripts/{unet_test,format_test,dae_test,sigma_sampler_test}.py,
dualdiffusion_tpu/dataset/processes.py:195-215.
"""

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.dataset import processes as JP
from dualdiffusion_tpu.dataset.processor import DatasetProcessorConfig as JaxProcConfig
from dualdiffusion_tpu.models.dae import DAE as JaxDAE
from dualdiffusion_tpu.models.dae import DAEConfig as JaxDAEConfig
from dualdiffusion_tpu.models.formats import SpectrogramFormat as JaxSpectrogramFormat
from dualdiffusion_tpu.models.formats import SpectrogramFormatConfig as JaxSpecConfig
from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from dualdiffusion_tpu.pipelines.pipeline import ModuleHandle as JaxModuleHandle
from dualdiffusion_tpu.pipelines.pipeline import Pipeline as JaxPipeline
from dualdiffusion_tpu_torch.dataset import processes as P
from dualdiffusion_tpu_torch.dataset.processor import DatasetProcessorConfig
from dualdiffusion_tpu_torch.scripts import dae_test, format_test, sigma_sampler_test, unet_test

ROOT = Path(__file__).resolve().parents[1]
SR = 32000
# a 32-bin mel on a 512-point STFT (16 ms window, hop 256), 4 Griffin-Lim
# iterations; a three-level fp32 DAE (ratio 4); a two-level UNet on its latents
SPEC_KW = dict(num_frequencies=32, window_duration_ms=16, padded_duration_ms=16,
               num_fgla_iters=4)
DAE_KW = dict(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
              num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8,
              in_num_freqs=32, compute_dtype="float32")
UNET_KW = dict(in_channels=8, out_channels=8, model_channels=16, channel_mult=(1, 2),
               num_layers_per_block=1, channels_per_head=16, logvar_channels=16,
               mlp_multiplier=2, mlp_groups=2)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_script(name, argv, monkeypatch, capsys) -> str:
    """The root script's ``main`` in this process (its ``--device cpu`` keeps
    JAX on the CPU, where the test process already has it)."""
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    capsys.readouterr()
    _jax_script(name).main()
    return capsys.readouterr().out


def _printed(pattern: str, text: str) -> float:
    m = re.search(pattern + r"\s*([-+0-9.eE]+)", text)
    assert m, (pattern, text)
    return float(m.group(1))


@pytest.fixture(scope="module")
def jax_model_dir(tmp_path_factory):
    """A tiny spectrogram + DAE + UNet model directory written by the JAX package."""
    fcfg, dcfg, ucfg = JaxSpecConfig(**SPEC_KW), JaxDAEConfig(**DAE_KW), JaxUNetConfig(**UNET_KW)
    dae, unet = JaxDAE(dcfg), JaxUNet(ucfg)
    dvars = jax.jit(dae.init)(jax.random.PRNGKey(3), jnp.zeros((1, 32, 64, 2)))
    uvars = jax.jit(lambda k: unet.init(k, jnp.zeros((1, 8, 16, 8)), jnp.ones((1,)),
                                        method=JaxUNet.init_all))(jax.random.PRNGKey(4))
    path = tmp_path_factory.mktemp("jax_model")
    JaxPipeline({"unet": JaxModuleHandle("unet", "unet", ucfg, unet, uvars),
                 "dae": JaxModuleHandle("dae", "dae", dcfg, dae, dvars),
                 "format": JaxModuleHandle("format", "format:spectrogram", fcfg,
                                           JaxSpectrogramFormat(fcfg))}).save_pretrained(path)
    return path


def test_dae_test_matches_the_jax_script(jax_model_dir, tmp_path, monkeypatch, capsys):
    """The same synthesized 0.5 s clip through the same fp32 DAE: the
    relative recon MSE to 2e-3 relative (plus the JAX script's 5-decimal
    print), and the same five files. The clip is four pure tones, so most
    mel bins hold only the STFT's fp32 rounding noise, which the mel's 0.25
    power lifts to ~2 % of the mel's max; the packages' FFTs round
    differently there, and their mels differ by ~1e-3 relative L2."""
    out = _run_jax_script("dae_test", ["--model_path", str(jax_model_dir), "--seconds", "0.5",
                                       "--output_path", str(tmp_path / "jax"), "--device", "cpu"],
                          monkeypatch, capsys)
    want = _printed("relative mel recon MSE:", out)
    got = dae_test.main(["--model_path", str(jax_model_dir), "--seconds", "0.5",
                         "--output_path", str(tmp_path / "port"), "--device", "cpu"])
    text = capsys.readouterr().out
    assert abs(got - want) <= 2e-3 * want + 5e-6 and 0 < got
    assert _printed("relative mel recon MSE:", text) == pytest.approx(got, abs=5e-6)
    assert "-> latents (1, 8, 15, 8)" in text
    for name in ("input.wav", "recon.wav", "mel.png", "mel_recon.png", "latents_pca.png"):
        assert (tmp_path / "port" / name).stat().st_size > 0, name
        assert (tmp_path / "jax" / name).is_file(), name
    assert json.loads(text.strip().splitlines()[-1].split(": ", 1)[1])["fgla_frame"] == 0


def test_format_test_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """The spectrogram format's round trip (4 Griffin-Lim iterations, fp32)
    on the same synthesized 0.5 s clip: the relative mel-domain MSE to 1e-2
    relative (plus the 5-decimal print). The mels differ as in the dae_test
    case, and Griffin-Lim's four iterations carry the difference into the
    phases: the two packages' MSEs differ by ~3.5e-3 relative."""
    def config(pkg):
        p = tmp_path / f"{pkg}.json"
        p.write_text(json.dumps({"format": "spectrogram", "format_config": SPEC_KW,
                                 "audio_path": None, "audio_seconds": 0.5,
                                 "output_path": str(tmp_path / pkg)}))
        return str(p)
    want = _printed("roundtrip:", _run_jax_script("format_test", ["--config", config("jax"),
                                                                   "--device", "cpu"],
                                                  monkeypatch, capsys))
    got = format_test.main(["--config", config("port"), "--device", "cpu"])
    text = capsys.readouterr().out
    assert abs(got - want) <= 1e-2 * want + 5e-6 and got > 0
    assert "sample shape (1, 32, 63, 2)" in text
    for name in ("input.wav", "recon.wav", "sample.png"):
        assert (tmp_path / "port" / name).stat().st_size > 0, name


def test_unet_test_writes_its_outputs(jax_model_dir, tmp_path):
    """Two seeds, 2 Heun steps at CFG 1.5 on a 64-frame clip, Griffin-Lim
    under "auto": each clip's audio, mel and latent images and sidecar
    under <model>/output/step_0/. (The draws are torch's, so the numbers
    are checked for sense, not against JAX's.)"""
    cfg = tmp_path / "unet_test.json"
    cfg.write_text(json.dumps({"unet_params": {"steps": 2, "cfg_scale": 1.5, "use_heun": True,
                                               "num_fgla_iters": 2, "length": 16384},
                               "seeds": [4000, 4001], "decode_mode": "auto"}))
    records = unet_test.main(["--model_path", str(jax_model_dir), "--config", str(cfg),
                              "--device", "cpu"])
    out = jax_model_dir / "output" / "step_0"
    assert [r["seed"] for r in records] == [4000, 4001]
    for r in records:
        tag = f"s{r['seed']}"
        assert (out / f"{tag}.flac").is_file() or (out / f"{tag}.wav").is_file()
        for suffix in ("_mel.png", "_latents.png"):
            assert (out / f"{tag}{suffix}").stat().st_size > 0
        side = json.loads((out / f"{tag}.json").read_text())
        assert side["params"]["steps"] == 2 and side["decode_mode"] == "auto"
        assert np.isfinite(side["latents_std"]) and side["latents_std"] > 0
    assert records[0]["latents_mean"] != records[1]["latents_mean"]


def test_sigma_sampler_test_matches_the_jax_script(monkeypatch, capsys):
    """Each distribution's median and range over 20,000 draws, against the
    JAX script's printout (4 significant digits): medians within 2 %."""
    out = _run_jax_script("sigma_sampler_test", [], monkeypatch, capsys)
    got = sigma_sampler_test.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert len(got) == 6
    for dist, sig in got.items():
        block = out.split(f"\n{dist}:")[1]
        assert np.median(sig) == pytest.approx(_printed("median", block), rel=2e-2), dist
        assert f"\n{dist}:" in text and text.count("ln sigma [") == 6 * 24


def test_harnesses_run_as_modules_and_need_a_card_unless_told():
    """``python -m`` runs a harness; ``--device cuda`` (the default) without
    a card exits with the message, never falling back to the CPU."""
    cmd = [sys.executable, "-m", "dualdiffusion_tpu_torch.scripts.sigma_sampler_test"]
    ok = subprocess.run(cmd + ["--device", "cpu"], cwd=ROOT, capture_output=True,
                        text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert "scale_invariant:" in ok.stdout and "kernel launches: " in ok.stdout
    if not torch.cuda.is_available():
        for mod in (format_test, sigma_sampler_test):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                mod.main([])


def test_spectrogram_encode_stage_matches_jax(jax_model_dir, tmp_path):
    """One stereo song (chords and noise, as the factory's own test makes
    them) through both packages' EncodeStage with the spectrogram-format DAE
    and a +2 semitone pitch offset (the format's min/max frequency scaled):
    float16 latents to fp32 rounding plus one float16 rounding (2e-3
    relative, plus 1e-4 of max). Without the noise, mel bins of pure STFT
    rounding noise, raised to the 0.25 power, differ between the packages
    by ~1e-3 relative L2 (see test_dae_test_matches_the_jax_script)."""
    rng = np.random.default_rng(1)
    t = np.arange(int(0.5 * SR)) / SR
    sig = sum(rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * rng.uniform(80, 4000) * t)
              for _ in range(4)) + 0.05 * rng.standard_normal(t.size)
    audio = (0.3 * np.stack([sig, 0.7 * sig]) / np.abs(sig).max()).astype(np.float32)
    item = {"path": str(tmp_path / "song.wav"), "audio": audio, "sample_rate": SR}
    kw = dict(pitch_shift_augmentations=(2,), encode_embeddings=False)
    jstage = JP.EncodeStage(JP.EncodeConfig(model_path=str(jax_model_dir), **kw))
    jstage.start_process(JaxProcConfig(dataset_path=str(tmp_path)), 0)
    want = jstage.process(dict(item))["tensors"]["latents"]
    stage = P.EncodeStage(P.EncodeConfig(model_path=str(jax_model_dir), device="cpu", **kw))
    stage.start_process(DatasetProcessorConfig(dataset_path=str(tmp_path)), 0)
    assert stage.formats[1].config.max_frequency == pytest.approx(16000 * 2 ** (2 / 12))
    got = stage.process(dict(item))["tensors"]["latents"]
    assert got.dtype == want.dtype == np.float16
    assert got.shape == want.shape and got.shape[:2] == (16, 8)
    g, w = got.astype(np.float32), want.astype(np.float32)
    assert np.isfinite(g).all()
    assert (np.abs(g - w) <= 2e-3 * np.abs(w) + 1e-4 * np.abs(w).max()).all()
    assert np.abs(w[8:] - w[:8]).max() > 0.01 * np.abs(w).max()


def test_pitch_shift_refuses_a_format_without_a_settable_top_frequency():
    """``ms_mdct_dual_v1`` has ``ms_freq_min`` but no top-frequency field,
    so JAX's encode stage (processes.py:195-199) fails on its pitch shift
    with ``AttributeError``; the port says why. The spectrogram and
    ``ms_mdct_dual`` formats shift as before."""
    from dualdiffusion_tpu_torch.models.formats import (MSMDCTDualV1Format,
                                                        MSMDCTDualV1FormatConfig,
                                                        SpectrogramFormat,
                                                        SpectrogramFormatConfig)
    with pytest.raises(ValueError, match="pitch-shift"):
        P.pitch_shifted_format(MSMDCTDualV1Format(MSMDCTDualV1FormatConfig()), 2)
    fmt = P.pitch_shifted_format(SpectrogramFormat(SpectrogramFormatConfig(**SPEC_KW)), -12)
    assert fmt.config.min_frequency == pytest.approx(10.0)
    assert fmt.config.max_frequency == pytest.approx(8000.0)
