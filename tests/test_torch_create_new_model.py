"""The port's model factory, ``python -m dualdiffusion_tpu_torch.create_new_model``,
against the JAX ``create_new_model.py``: a tiny config directory (UNet, DAE,
DDEC, format) gives the same flat keys and shapes in both, MP-normalized
weights, directories that load in both packages, train scripts that run the
port's train entry, and the refusal of an existing directory; for the full
``configs/models/edm2_default`` the port's parameter shapes equal those of
``jax.eval_shape`` over the JAX ``init_module`` (nothing compiled or drawn).
"""

import json
import logging
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import create_new_model as jax_cnm
from dualdiffusion_tpu.pipelines.pipeline import Pipeline as JaxPipeline, _flatten
from dualdiffusion_tpu.pipelines.pipeline import get_module_class as jax_module_class
from dualdiffusion_tpu.utils import config_from_dict as jax_config_from_dict
from dualdiffusion_tpu_torch import create_new_model as cnm
from dualdiffusion_tpu_torch.pipelines.pipeline import Pipeline, get_module_class
from dualdiffusion_tpu_torch.utils import config_from_dict, load_json, load_safetensors
from dualdiffusion_tpu_torch.weights import flax_key

ROOT = Path(__file__).resolve().parents[1]

#: widths of tests/test_pipeline.py make_pipeline, a DDEC with the PSD fold
#: and the constant channel, and the repository's tiny test format
TINY = {
    "model_index": {"modules": {"format": "format:ms_mdct_dual", "dae": "dae",
                                "unet": "unet", "ddec": "ddec"}},
    "unet": {"in_channels": 4, "out_channels": 4, "in_channels_emb": 16, "in_num_freqs": 8,
             "model_channels": 8, "channel_mult": [1, 2], "num_layers_per_block": 1,
             "channels_per_head": 8, "logvar_channels": 16, "mlp_groups": 2},
    "dae": {"model_channels": 8, "channel_mult_enc": [1, 2], "channel_mult_dec": [1, 2],
            "num_enc_layers_per_block": 1, "num_dec_layers_per_block": 1,
            "latent_channels": 4, "in_num_freqs": 16},
    "ddec": {"in_channels": 2, "out_channels": 2, "in_channels_emb": 0, "in_num_freqs": 16,
             "in_psd_freqs": 32, "model_channels": 8, "logvar_channels": 16,
             "channel_mult": [1, 2], "num_layers_per_block": 1, "channels_per_head": 8,
             "attn_levels": [], "mlp_groups": 1, "add_constant_channel": True},
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _config_dir(tmp_path) -> Path:
    d = tmp_path / "configs" / "tiny"
    d.mkdir(parents=True)
    for name, cfg in TINY.items():
        (d / f"{name}.json").write_text(json.dumps(cfg))
    (d / "format.json").write_text((ROOT / "configs/models/edm2_default/format.json").read_text())
    (d / "unet_train.json").write_text("{}")
    return d.parent


def _create_port(cfg_root, out_root, *extra):
    return cnm.main(["--name", "tiny", "--config_path", str(cfg_root), "--output_path",
                     str(out_root), "--device", "cpu", *extra])


def _create_jax(cfg_root, out_root, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["create_new_model.py", "--name", "tiny", "--config_path",
                                      str(cfg_root), "--output_path", str(out_root)])
    jax_cnm.main()
    return Path(out_root) / "tiny"


def _flat_shapes(model_dir, name):
    return {k: v.shape for k, v in load_safetensors(Path(model_dir) / name /
                                                    f"{name}.safetensors").items()}


def test_tiny_model_matches_jax_keys_and_shapes(tmp_path, monkeypatch, caplog):
    """Every weight file holds the JAX keys with the JAX shapes; the logged
    per-module counts are JAX's; each module's MP weights have unit RMS per
    output channel; both packages load both directories."""
    cfg_root = _config_dir(tmp_path)
    with caplog.at_level(logging.INFO):
        port_dir = _create_port(cfg_root, tmp_path / "port")
    port_log = [r.getMessage() for r in caplog.records if r.name == "create_new_model"]
    caplog.clear()
    with caplog.at_level(logging.INFO):
        jax_dir = _create_jax(cfg_root, tmp_path / "jax", monkeypatch)
    jax_log = [r.getMessage() for r in caplog.records if r.name == "create_new_model"]
    counts = lambda log: [m for m in log if "params" in m]
    assert counts(port_log) == counts(jax_log) and len(counts(port_log)) == 4

    assert load_json(port_dir / "model_index.json")["modules"] == TINY["model_index"]["modules"]
    for name in ("unet", "dae", "ddec"):
        assert _flat_shapes(port_dir, name) == _flat_shapes(jax_dir, name), name
        flat = load_safetensors(port_dir / name / f"{name}.safetensors")
        mp = [v for k, v in flat.items() if k.endswith("/w_mp")]
        assert mp
        for w in mp:
            rms = np.sqrt(np.mean(w.reshape(w.shape[0], -1) ** 2, axis=1))
            # normalize's eps (1e-4) leaves an RMS of r / (r + 1e-4) for a row of RMS r
            assert np.all(rms <= 1.0) and np.all(rms > 0.99), (name, rms)
        # the weights are drawn, not left at a constant
        assert np.std(np.concatenate([w.ravel() for w in mp])) > 0.5

    for d in (port_dir, jax_dir):
        pipe = Pipeline.from_pretrained(d, device="cpu")
        assert set(pipe.modules) == {"format", "dae", "unet", "ddec"}
        jpipe = JaxPipeline.from_pretrained(d)
        assert set(jpipe.modules) == {"format", "dae", "unet", "ddec"}
        for name in ("unet", "dae", "ddec"):
            want = {k: np.shape(v) for k, v in _flatten(jpipe.modules[name].variables).items()}
            got = {flax_key(k, v.dim() == 0): tuple(v.shape) or (1,)
                   for k, v in pipe.modules[name].module.state_dict().items()}
            assert got == want, name


def test_train_scripts_and_refusal(tmp_path):
    """One ``train_<module>.sh`` per module that is not a format, each running
    ``python -m dualdiffusion_tpu_torch.train`` on the new directory and the
    module's train config; a second run into the same directory exits 1 and
    leaves it as it was."""
    cfg_root = _config_dir(tmp_path)
    out = _create_port(cfg_root, tmp_path / "out", "--seed", "7")
    scripts = sorted(p.name for p in out.glob("train_*.sh"))
    assert scripts == ["train_dae.sh", "train_ddec.sh", "train_unet.sh"]
    text = (out / "train_unet.sh").read_text()
    assert "python -m dualdiffusion_tpu_torch.train" in text
    assert f"--model_path {out.resolve()}" in text
    assert f"--train_config_path {(cfg_root / 'tiny' / 'unet_train.json').resolve()}" in text
    assert f"PYTHONPATH=\"{ROOT}" in text
    assert (out / "train_unet.sh").stat().st_mode & 0o100
    before = (out / "unet" / "unet.safetensors").read_bytes()
    with pytest.raises(SystemExit) as e:
        _create_port(cfg_root, tmp_path / "out")
    assert e.value.code == 1
    assert (out / "unet" / "unet.safetensors").read_bytes() == before


def test_seed_sets_the_weights(tmp_path):
    """The same seed writes the same weights, another seed other weights."""
    cfg_root = _config_dir(tmp_path)
    a = load_safetensors(_create_port(cfg_root, tmp_path / "a", "--seed", "3") / "unet" /
                         "unet.safetensors")
    b = load_safetensors(_create_port(cfg_root, tmp_path / "b", "--seed", "3") / "unet" /
                         "unet.safetensors")
    c = load_safetensors(_create_port(cfg_root, tmp_path / "c", "--seed", "4") / "unet" /
                         "unet.safetensors")
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert any(not np.array_equal(a[k], c[k]) for k in a if k.endswith("w_mp"))


def test_no_card_refuses_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cnm.main(["--name", "tiny", "--config_path", str(_config_dir(tmp_path)),
                  "--output_path", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("name", ["unet", "dae", "ddec"])
def test_edm2_default_shapes_match_jax_eval_shape(name):
    """The full ``configs/models/edm2_default`` module, built on the meta
    device, has the parameter keys and shapes of ``jax.eval_shape`` over the
    JAX ``init_module`` (its normalization included)."""
    cfg_dir = ROOT / "configs" / "models" / "edm2_default"
    mtype = load_json(cfg_dir / "model_index.json")["modules"][name]
    raw = load_json(cfg_dir / f"{name}.json")
    jcfg = jax_config_from_dict(jax_module_class(mtype)[1], raw)
    want = jax.eval_shape(lambda k: jax_cnm.init_module(mtype, jcfg, k)[1],
                          jax.random.PRNGKey(0))
    want = _flatten_shapes(want)
    factory, cfg_cls = get_module_class(mtype)
    module = factory(config_from_dict(cfg_cls, raw), "meta")
    got = {flax_key(k, v.dim() == 0): tuple(v.shape) or (1,)
           for k, v in module.state_dict().items()}
    assert got == want
    assert cnm.module_param_counts(module)["total"] == sum(int(np.prod(s)) for s in want.values())


def _flatten_shapes(tree):
    """``_flatten``'s keys over a tree of ShapeDtypeStructs."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(p.key) for p in path)
        out[key + "#0d" if leaf.shape == () else key] = tuple(leaf.shape) or (1,)
    return out
