"""Post-hoc EMAs and prompt embeddings of the port against the JAX package:
``solve_posthoc_coefficients``, ``reconstruct_phema`` on bf16 archives
written by either package's ``save_ema_archive``, ``from_pretrained``'s
``phema_<std>`` branch (a saved ``ema_<name>.safetensors`` first, as JAX
does), ``get_available_emas``, ``dataset_embeddings.safetensors`` in both
directions and ``get_prompt_embedding``.

<-> dualdiffusion_tpu/training/ema.py:58-78, 418-459 and
dualdiffusion_tpu/pipelines/pipeline.py:118-153, 299-420.
"""

import numpy as np
import pytest
import torch

from dualdiffusion_tpu.pipelines.pipeline import Pipeline as JaxPipeline
from dualdiffusion_tpu.pipelines.pipeline import _flatten, _unflatten
from dualdiffusion_tpu.pipelines.pipeline import load_module as jax_load_module
from dualdiffusion_tpu.training import ema as jax_ema
from dualdiffusion_tpu_torch.models import UNet, UNetConfig
from dualdiffusion_tpu_torch.pipelines import Pipeline
from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle
from dualdiffusion_tpu_torch.training.ema import (power_function_correlation,
                                                  reconstruct_phema, save_ema_archive,
                                                  solve_posthoc_coefficients)
from dualdiffusion_tpu_torch.utils import save_safetensors
from dualdiffusion_tpu_torch.weights import to_flat

UNET_KW = dict(in_channels=4, out_channels=4, model_channels=8, channel_mult=(1, 2),
               num_layers_per_block=1, channels_per_head=8, logvar_channels=16)
#: (global step, samples processed, std) of the archived snapshots
ARCHIVES = ((100, 800, 0.05), (200, 1600, 0.05), (200, 1600, 0.1))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _unet(seed=0):
    g = torch.Generator().manual_seed(seed)
    unet = UNet(UNetConfig(**UNET_KW)).init_weights(g)
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if p.dim() == 0:
                p.fill_(0.7 + 0.1 * seed)
    return unet


def _scalar_keys(flat):
    """A flat dict with the 0-d leaves of the tiny UNet (its gains, stored
    by the JAX package as 0-d or (1,) under bare keys) as the port writes
    them: shape (1,) under a '#0d' key."""
    scalars = {k[:-3] for k in to_flat(_unet()) if k.endswith("#0d")}
    return {(k + "#0d" if k in scalars else k): np.asarray(v).reshape(np.shape(v) or (1,))
            for k, v in flat.items()}


def _write_archives(d, writer):
    """Three archives of perturbed weights (seeded) under ``d``, written by
    the JAX package or the port."""
    d.mkdir(parents=True, exist_ok=True)
    for i, (step, n, std) in enumerate(ARCHIVES):
        unet = _unet()
        with torch.no_grad():
            g = torch.Generator().manual_seed(100 + i)
            for p in unet.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g))
        path = d / f"{step}_ema_std{std}.safetensors"
        if writer == "port":
            save_ema_archive(dict(unet.state_dict()), path, step, n, std)
        else:
            jax_ema.save_ema_archive(_unflatten(to_flat(unet)), str(path), step, n, std)


def _model_dir(tmp_path):
    """A port-written directory with one UNet and the dataset embeddings."""
    d = tmp_path / "model"
    cfg = UNetConfig(**UNET_KW)
    rng = np.random.default_rng(0)
    emb = {f"{label}_{kind}": rng.standard_normal(16).astype(np.float32)
           for label in ("a", "b") for kind in ("audio", "text")}
    emb["_unconditional_audio"] = rng.standard_normal(16).astype(np.float32)
    Pipeline({"unet": ModuleHandle("unet", "unet", cfg, _unet())},
             dataset_embeddings=emb).save_pretrained(d)
    return d


def test_posthoc_solver_matches_jax():
    """The profile correlation and the least-squares mixing coefficients:
    the same float64 numpy on both sides (1e-12)."""
    in_ofs = np.array([800.0, 1600.0, 1600.0, 3200.0])
    in_std = np.array([0.05, 0.05, 0.1, 0.1])
    for out_ofs, out_std in ((3200.0, 0.05), (3200.0, 0.08), (2400.0, 0.15)):
        got = solve_posthoc_coefficients(in_ofs, in_std, np.array([out_ofs]),
                                         np.array([out_std]))
        want = jax_ema.solve_posthoc_coefficients(in_ofs, in_std, np.array([out_ofs]),
                                                  np.array([out_std]))
        assert got.shape == (4, 1)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        assert abs(got.sum() - 1.0) < 1e-12
    a = power_function_correlation(in_ofs[:, None], in_std[:, None], in_ofs[None], in_std[None])
    np.testing.assert_allclose(a, jax_ema.power_function_correlation(
        in_ofs[:, None], in_std[:, None], in_ofs[None], in_std[None]), rtol=1e-12)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reconstruct_phema_matches_jax(tmp_path, writer):
    """Both packages' reconstructions from the same bf16 archives (written
    by ``writer``): float64 sums of the same terms, so equal to fp32
    rounding (1e-7 relative), under the archive's keys (the port writes
    0-d leaves under '#0d' keys, the JAX package under bare ones)."""
    _write_archives(tmp_path / "archive", writer)
    for std in (0.05, 0.08):
        got = reconstruct_phema(std, tmp_path / "archive")
        want = jax_ema.reconstruct_phema(std, str(tmp_path / "archive"))
        assert sorted(got) == sorted(want)
        assert sorted(_scalar_keys(got)) == sorted(to_flat(_unet()))
        for k in got:
            assert got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], rtol=1e-7, atol=1e-8)
    with pytest.raises(FileNotFoundError):
        reconstruct_phema(0.05, tmp_path)


def _same_flat(a, b):
    a, b = _scalar_keys(a), _scalar_keys(b)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k], np.float32), np.asarray(b[k], np.float32),
                                   rtol=1e-7, atol=1e-8)


def test_from_pretrained_loads_a_posthoc_ema_as_jax_does(tmp_path):
    """``load_emas={"unet": "phema_0.05"}`` reconstructs from
    ``unet/ema_archive/`` in both packages: the same weights."""
    d = _model_dir(tmp_path)
    _write_archives(d / "unet" / "ema_archive", "jax")
    pipe = Pipeline.from_pretrained(d, device="cpu", load_emas={"unet": "phema_0.05"})
    _, _, want = jax_load_module(d, "unet", load_ema="phema_0.05")
    _same_flat(to_flat(pipe.modules["unet"].module), _flatten(want))
    assert not np.array_equal(to_flat(pipe.modules["unet"].module)["params/core/out_gain#0d"],
                              to_flat(_unet())["params/core/out_gain#0d"])


def test_a_saved_ema_file_comes_before_the_archive(tmp_path):
    """JAX's order: ``ema_phema_0.05.safetensors``, where it exists, is
    loaded as it is, and the archive beside it is not read."""
    d = _model_dir(tmp_path)
    _write_archives(d / "unet" / "ema_archive", "port")
    saved = to_flat(_unet(seed=3))
    save_safetensors(saved, d / "unet" / "ema_phema_0.05.safetensors")
    pipe = Pipeline.from_pretrained(d, device="cpu", load_emas={"unet": "phema_0.05"})
    _same_flat(to_flat(pipe.modules["unet"].module), saved)
    _, _, want = jax_load_module(d, "unet", load_ema="phema_0.05")
    _same_flat(_flatten(want), saved)


def test_missing_emas_raise_as_in_jax(tmp_path):
    """No file and no ``unet/ema_archive/``: FileNotFoundError in both. An
    archive where both trainers write it (``<model>/unet_ema_archive/``) is
    not read by either (a fault of the JAX package that the port keeps)."""
    d = _model_dir(tmp_path)
    _write_archives(d / "unet_ema_archive", "port")
    for sel in ("phema_0.05", "std0.05"):
        with pytest.raises(FileNotFoundError):
            Pipeline.from_pretrained(d, device="cpu", load_emas={"unet": sel})
        with pytest.raises(FileNotFoundError):
            jax_load_module(d, "unet", load_ema=sel)
    with pytest.raises(ValueError):
        Pipeline.from_pretrained(d, device="cpu", load_emas={"unet": "../x"})


def test_get_available_emas_matches_jax(tmp_path):
    d = _model_dir(tmp_path)
    assert Pipeline.get_available_emas(d, "unet") == [] == \
        JaxPipeline.get_available_emas(d, "unet")
    for name in ("std0.10", "std0.05", "phema_0.2"):
        save_safetensors(to_flat(_unet()), d / "unet" / f"ema_{name}.safetensors")
    (d / "unet" / "notes.txt").write_text("x")
    got = Pipeline.get_available_emas(d, "unet")
    assert got == JaxPipeline.get_available_emas(d, "unet") == ["phema_0.2", "std0.05",
                                                                "std0.10"]
    assert Pipeline.get_available_emas(d, "missing") == []


def test_dataset_embeddings_round_trip_both_ways(tmp_path):
    """Port-written ``dataset_embeddings.safetensors`` loads in JAX, and
    JAX-written in the port, unchanged."""
    d = _model_dir(tmp_path)
    port = Pipeline.from_pretrained(d, device="cpu")
    jpipe = JaxPipeline.from_pretrained(d)
    assert sorted(jpipe.dataset_embeddings) == sorted(port.dataset_embeddings) == \
        ["_unconditional_audio", "a_audio", "a_text", "b_audio", "b_text"]
    jpipe.dataset_embeddings["c_audio"] = np.full(16, 0.5, np.float32)
    jpipe.save_pretrained(tmp_path / "jax")
    back = Pipeline.from_pretrained(tmp_path / "jax", device="cpu")
    assert sorted(back.dataset_embeddings) == sorted(jpipe.dataset_embeddings)
    for k, v in jpipe.dataset_embeddings.items():
        np.testing.assert_array_equal(back.dataset_embeddings[k], np.asarray(v))
        if k != "c_audio":
            np.testing.assert_array_equal(port.dataset_embeddings[k], np.asarray(v))
    Pipeline({}, {}).save_pretrained(tmp_path / "none")
    assert not (tmp_path / "none" / "dataset_embeddings.safetensors").exists()


def test_get_prompt_embedding_matches_jax(tmp_path):
    """Weighted label sums of audio and text embeddings, normalized (1e-6
    relative); the unconditional audio embedding for a prompt without a
    known label; None without dataset embeddings."""
    d = _model_dir(tmp_path)
    pipe = Pipeline.from_pretrained(d, device="cpu")
    jpipe = JaxPipeline.from_pretrained(d)
    for prompt in ({"a": 1.0}, {"a": 0.5, "b": 2.0}, {}, {"unknown": 1.0}, {"b": -1.0}):
        got = pipe.get_prompt_embedding(prompt)
        want = np.asarray(jpipe.get_prompt_embedding(prompt))
        assert got.shape == want.shape == (1, 16) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    uncond = pipe.get_prompt_embedding({})
    np.testing.assert_allclose(uncond.numpy(), pipe.get_prompt_embedding({"unknown": 1.0}))
    assert Pipeline({}).get_prompt_embedding({"a": 1.0}) is None
    del pipe.dataset_embeddings["_unconditional_audio"]
    assert pipe.get_prompt_embedding({}) is None
