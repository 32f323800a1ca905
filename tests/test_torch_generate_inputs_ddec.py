"""``encode_input_audio`` and ``generate`` with ``input_audio``,
``input_latents``, ``inpainting_mask`` and ``seamless_loop`` on the tiny
JAX-written DDEC model of tests/test_torch_ddec.py (``decode_mode="ddec"``)
against the JAX package; the checks and their tolerances are those of
tests/test_torch_generate_inputs.py.

<-> dualdiffusion_tpu/pipelines/pipeline.py ``diffusion_decode``,
``encode_input_audio`` and ``generate``.
"""

import pytest
import torch

from test_torch_generate_inputs import (check_encode_input_audio, check_generate_options,
                                        check_seamless_generate)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_encode_input_audio_matches_jax(tmp_path):
    check_encode_input_audio(tmp_path, "ddec")


@pytest.mark.parametrize("kind", ["input_audio", "input_latents", "inpainting"])
def test_generate_options_match_jax(tmp_path, monkeypatch, kind):
    check_generate_options(tmp_path, monkeypatch, "ddec", kind)


def test_seamless_generate_matches_jax(tmp_path, monkeypatch):
    check_seamless_generate(tmp_path, monkeypatch, "ddec")
