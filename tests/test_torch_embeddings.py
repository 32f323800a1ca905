"""The port's embedding helpers, CLAP gate and wrapper, and the numeric and
image helpers of utils/utils.py, against the JAX package. No CLAP weights
exist here: the wrapper's chunking, downmix, resampling and normalize/concat
run on injected deterministic models (the stand-ins of JAX
tests/test_reference_parity.py test_clap_normalize_concat_parity), and the
gate is held to its error without weights.

<-> dualdiffusion_tpu/models/embeddings.py and utils/utils.py:209-330.
"""

import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from dualdiffusion_tpu.models import embeddings as jemb
from dualdiffusion_tpu.utils import utils as jutils
from dualdiffusion_tpu_torch.models import embeddings as emb
from dualdiffusion_tpu_torch.utils import utils

SR = 32000


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_embedding_helpers_match_jax():
    """cosine_similarity_matrix, dedupe_embeddings (plain and smoothed) and
    mp_normalize: the same numpy arithmetic, equal results."""
    rng = np.random.default_rng(1)
    e = rng.standard_normal((12, 32)).astype(np.float32)
    e[5] = e[2] + 1e-3 * rng.standard_normal(32)
    e[9] = e[0] * 2.0
    np.testing.assert_array_equal(emb.cosine_similarity_matrix(e, e[:4]),
                                  jemb.cosine_similarity_matrix(e, e[:4]))
    for window in (1, 3):
        np.testing.assert_array_equal(emb.dedupe_embeddings(e, 0.99, window),
                                      jemb.dedupe_embeddings(e, 0.99, window))
    assert 5 not in emb.dedupe_embeddings(e, 0.99) and 9 not in emb.dedupe_embeddings(e, 0.99)
    got = emb.mp_normalize(e)
    np.testing.assert_array_equal(got, jemb.mp_normalize(e))
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), np.sqrt(32), rtol=1e-3)


class _StubTransformers(types.ModuleType):
    """A ``transformers`` whose CLAP classes find no weights, as the real one
    does offline without a checkpoint."""

    def __init__(self):
        super().__init__("transformers")

        class Missing:
            @staticmethod
            def from_pretrained(path, local_files_only=False):
                raise OSError(f"no checkpoint at {path} (local_files_only={local_files_only})")
        self.ClapModel = self.ClapProcessor = Missing


def test_clap_gate_raises_without_weights(tmp_path, monkeypatch):
    """No weights and no download: both packages raise RuntimeError. The
    port raises before it imports ``transformers`` when CLAP_MODEL_PATH is
    unset, and when the path lacks a model's directory; with the directories
    present but no checkpoint in them, ``transformers`` fails and both
    raise the same error."""
    monkeypatch.delenv("CLAP_ALLOW_DOWNLOAD", raising=False)
    monkeypatch.delenv("CLAP_MODEL_PATH", raising=False)
    monkeypatch.setitem(sys.modules, "transformers", None)   # any import of it fails
    with pytest.raises(RuntimeError, match="CLAP_MODEL_PATH"):
        emb.CLAPEmbedding(device="cpu")._load()
    monkeypatch.setenv("CLAP_MODEL_PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="transformers is required"):
        emb.CLAPEmbedding(device="cpu")._load()
    monkeypatch.setitem(sys.modules, "transformers", _StubTransformers())
    with pytest.raises(RuntimeError, match="CLAP weights unavailable at .*larger_clap_music"):
        emb.CLAPEmbedding(device="cpu")._load()
    for name in ("larger_clap_music", "clap-htsat-unfused"):
        (tmp_path / name).mkdir()
    for clap in (emb.CLAPEmbedding(device="cpu"), jemb.CLAPEmbedding()):
        with pytest.raises(RuntimeError, match="CLAP weights unavailable at .*larger_clap_music"):
            clap._load()


class _Proc:
    def __call__(self, audios=None, sampling_rate=None, return_tensors=None, **kw):
        return {"input_features": torch.stack([torch.as_tensor(a) for a in audios])}


class _Model:
    def __init__(self, fn):
        self.fn = fn

    def get_audio_features(self, input_features):
        return self.fn(input_features)


@pytest.mark.parametrize("sample_rate", [48000, SR])
def test_clap_chunking_and_concat_match_jax(sample_rate):
    """The downmix, the linear resample to 48 kHz (none at 48 kHz), 10 s
    chunks with the tail dropped, and the per-model mp-normalize and concat
    on injected models: equal chunks, embeddings to fp32 rounding (1e-6)."""
    audio = np.random.default_rng(7).standard_normal(
        (2, int(sample_rate * 23.7))).astype(np.float32)
    models = [(_Model(lambda t: t[:, :512] * 3.0 + 0.25), _Proc()),
              (_Model(lambda t: t[:, 512:1024] * -2.0 + 0.5), _Proc())]
    jclap, clap = jemb.CLAPEmbedding(), emb.CLAPEmbedding(device="cpu")
    jclap._models, clap._models = models, models
    np.testing.assert_array_equal(clap._chunk_audio(audio, sample_rate),
                                  jclap._chunk_audio(audio, sample_rate))
    want, got = jclap.encode_audio(audio, sample_rate), clap.encode_audio(audio, sample_rate)
    assert got.shape == want.shape == (2, 1024)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert abs(np.linalg.norm(got[0, :512]) - np.sqrt(512)) < 1.0
    with pytest.raises(ValueError):
        clap._chunk_audio(audio[:, :sample_rate], sample_rate)


def test_numeric_helpers_match_jax():
    """quantize/dequantize (8 and 16 bit), mu-law, cos_angle, slerp (and its
    near-parallel fallback) and fractal noise from one seed: equal."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    for levels in (256, 4096):
        codes, scale, offset = utils.quantize_tensor(x, levels)
        jcodes, jscale, joffset = jutils.quantize_tensor(x, levels)
        np.testing.assert_array_equal(codes, jcodes)
        assert codes.dtype == jcodes.dtype and (scale, offset) == (jscale, joffset)
        back = utils.dequantize_tensor(codes, scale, offset)
        np.testing.assert_array_equal(back, jutils.dequantize_tensor(jcodes, jscale, joffset))
        assert np.abs(back - x).max() <= scale / 2 + 1e-6
    y = np.clip(x, -1, 1)
    np.testing.assert_array_equal(utils.mu_law_encode(y), jutils.mu_law_encode(y))
    np.testing.assert_allclose(utils.mu_law_decode(utils.mu_law_encode(y)), y, atol=1e-5)
    a, b = x[0], x[1]
    assert utils.cos_angle(a, b) == jutils.cos_angle(a, b)
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(utils.slerp(a, b, t), jutils.slerp(a, b, t))
        np.testing.assert_array_equal(utils.slerp(a, a * 2, t), jutils.slerp(a, a * 2, t))
    got = utils.fractal_noise_2d((24, 40), 4, 0.6, np.random.default_rng(9))
    want = jutils.fractal_noise_2d((24, 40), 4, 0.6, np.random.default_rng(9))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.shape == (24, 40)


def test_save_img_and_safetensors_metadata_match_jax(tmp_path):
    """``save_img`` writes the PNG the JAX one (PIL) writes, pixel for
    pixel, for an RGB and a gray image; ``load_safetensors_metadata`` reads
    what either package's ``save_safetensors`` wrote."""
    rng = np.random.default_rng(4)
    for i, img in enumerate((rng.integers(0, 256, (12, 20, 3), dtype=np.uint8),
                             rng.integers(0, 256, (9, 7), dtype=np.uint8))):
        utils.save_img(img, tmp_path / f"port{i}.png")
        jutils.save_img(img, tmp_path / f"jax{i}.png")
        got = np.asarray(Image.open(tmp_path / f"port{i}.png").convert("RGB"))
        want = np.asarray(Image.open(tmp_path / f"jax{i}.png").convert("RGB"))
        np.testing.assert_array_equal(got, want)
    meta = {"step": "12", "note": "dae"}
    jutils.save_safetensors({"a": np.zeros(3, np.float32)}, tmp_path / "j.safetensors", meta)
    utils.save_safetensors({"a": np.zeros(3, np.float32)}, tmp_path / "p.safetensors", meta)
    for name in ("j", "p"):
        assert utils.load_safetensors_metadata(tmp_path / f"{name}.safetensors") == meta
        assert jutils.load_safetensors_metadata(tmp_path / f"{name}.safetensors") == meta
