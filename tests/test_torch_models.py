"""UNet forward and DAE decode of the port against the JAX package, on
weights initialised by JAX and carried over by dualdiffusion_tpu_torch.weights
(the bench "small" geometry, with mlp_groups=2 so the grouped conv runs)."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.models.dae import DAE as JaxDAE
from dualdiffusion_tpu.models.dae import DAEConfig as JaxDAEConfig
from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu.utils import config_from_dict as jax_config_from_dict
from dualdiffusion_tpu.utils import config_to_dict as jax_config_to_dict
from dualdiffusion_tpu.utils import load_json
from dualdiffusion_tpu.utils.perf import unet_fwd_flops as jax_unet_fwd_flops
from dualdiffusion_tpu_torch.models import DAE, DAEConfig, UNet, UNetConfig
from dualdiffusion_tpu_torch.utils import config_from_dict, config_to_dict
from dualdiffusion_tpu_torch.utils.perf import unet_fwd_flops
from dualdiffusion_tpu_torch.weights import load_flat, to_flat

UNET_KW = dict(in_channels=8, out_channels=8, in_channels_emb=1024, model_channels=16,
               channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=16,
               logvar_channels=32, mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
DAE_KW = dict(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
              num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _nonzero_gains(variables, seed):
    """Give every zero-initialised scalar gain (out_gain, emb_gain*) a value,
    so the residual branches and the emb modulation are exercised."""
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        name = getattr(path[-1], "key", "")
        if leaf.ndim == 0 and ("gain" in name):
            return jnp.asarray(rng.uniform(0.5, 1.5), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(fix, variables)


@functools.lru_cache(maxsize=None)
def _jax_unet():
    cfg = JaxUNetConfig(**UNET_KW)
    unet = JaxUNet(cfg)
    v = jax.jit(lambda k: unet.init(k, jnp.zeros((1, 16, 32, 8)), jnp.ones((1,)),
                                    jnp.zeros((1, 1024)), method=JaxUNet.init_all))(
        jax.random.PRNGKey(0))
    return unet, _nonzero_gains(v, 0)


def test_unet_forward_matches_jax():
    """Embeddings (fp32) to 1e-5; the forward runs in bf16 in both
    packages, which round at different places (the JAX CPU path sums
    grouped-conv taps in bf16, the port in fp32), so the denoised output is
    compared to 3e-2 of its max."""
    junet, jvars = _jax_unet()
    tunet = UNet(UNetConfig(**UNET_KW)).eval()
    load_flat(tunet, _flatten(jvars))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 32, 8)).astype(np.float32) * 3.0
    sigma = np.array([2.5, 0.7], np.float32)
    emb_in = rng.standard_normal((2, 1024)).astype(np.float32)
    mask = np.array([1.0, 0.0], np.float32)

    j_emb = jax.jit(lambda v, e, m: junet.apply(v, e, m, method=JaxUNet.get_embeddings))(
        jvars, jnp.asarray(emb_in), jnp.asarray(mask))
    want = jax.jit(junet.apply)(jvars, jnp.asarray(x), jnp.asarray(sigma), j_emb)
    with torch.no_grad():
        t_emb = tunet.get_embeddings(torch.from_numpy(emb_in), torch.from_numpy(mask))
        got = tunet(torch.from_numpy(x), torch.from_numpy(sigma), t_emb)
    assert _rel_err(t_emb.numpy(), j_emb) < 1e-5
    # the network branch only: subtract the shared c_skip * x term
    c_skip = (1.0 / (sigma ** 2 + 1.0)).reshape(-1, 1, 1, 1)
    assert _rel_err(got.numpy() - c_skip * x, np.asarray(want) - c_skip * x) < 3e-2


@functools.lru_cache(maxsize=None)
def _jax_dae_init():
    jdae = JaxDAE(JaxDAEConfig(**DAE_KW))
    return jax.jit(jdae.init)(jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 2)))


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_dae_decode_matches_jax(compute_dtype, tol):
    """fp32 compute agrees to float rounding through ~10 convs (1e-4);
    bf16 compute to bf16 rounding (3e-2 of max)."""
    jdae = JaxDAE(JaxDAEConfig(**DAE_KW, compute_dtype=compute_dtype))
    jvars = _nonzero_gains(_jax_dae_init(), 1)
    jvars["stats"]["latents_mean"] = jnp.arange(8, dtype=jnp.float32) * 0.1
    lat = np.random.default_rng(3).standard_normal((1, 16, 16, 8)).astype(np.float32)
    want = jax.jit(lambda v, z: jdae.apply(v, z, method=JaxDAE.decode))(jvars, jnp.asarray(lat))
    tdae = DAE(DAEConfig(**DAE_KW, compute_dtype=compute_dtype)).eval()
    load_flat(tdae, _flatten(jvars))
    with torch.no_grad():
        got = tdae.decode(torch.from_numpy(lat))
        unnorm = tdae.unnormalize_latents(torch.from_numpy(lat))
    assert got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) < tol
    want_un = jdae.apply(jvars, jnp.asarray(lat), method=JaxDAE.unnormalize_latents)
    assert _rel_err(unnorm.numpy(), want_un) < 1e-6


def test_weight_bridge_round_trips_exactly():
    """JAX flat dict -> port state_dict -> flat dict is the identity, keys,
    shapes ('#0d' scalars included) and values."""
    _, jvars = _jax_unet()
    flat = _flatten(jvars)
    tunet = UNet(UNetConfig(**UNET_KW))
    load_flat(tunet, flat)
    back = to_flat(tunet)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k
    flat.pop("params/core/out_gain#0d")
    with pytest.raises(KeyError):
        load_flat(tunet, flat)


CONFIGS = Path(__file__).resolve().parents[1] / "configs" / "models"


@pytest.mark.parametrize("path", sorted(str(p) for p in CONFIGS.glob("*/*.json")
                                        if p.name in ("unet.json", "ddec.json", "dae.json")))
def test_model_json_loads_into_both_packages(path):
    """The same config JSON hydrates into the JAX and the port dataclasses
    with the same field values."""
    raw = load_json(path)
    jcls, tcls = ((JaxDAEConfig, DAEConfig) if path.endswith("dae.json")
                  else (JaxUNetConfig, UNetConfig))
    assert config_to_dict(config_from_dict(tcls, raw)) == \
        jax_config_to_dict(jax_config_from_dict(jcls, raw))


@pytest.mark.parametrize("path", sorted(str(p) for p in CONFIGS.glob("*/ddec.json")))
def test_unet_fwd_flops_matches_jax(path):
    """The port's copy of ``unet_fwd_flops`` counts what JAX's does for each
    DDEC config at the 45 s MDCT shape (1, 256, 5504, 2), the PSD fold's and
    the constant channel's input-conv channels included."""
    raw = load_json(path)
    want = jax_unet_fwd_flops(jax_config_from_dict(JaxUNetConfig, raw), 1, 256, 5504)
    assert unet_fwd_flops(config_from_dict(UNetConfig, raw), 1, 256, 5504) == want > 0


def test_tpu_only_fields_raise_when_set():
    """W-packing is the one TPU-only field; ``remat_blocks`` is ported and
    builds, but does not excuse W-packing."""
    with pytest.raises(NotImplementedError):
        UNet(UNetConfig(**UNET_KW, w_pack_channels=128))
    assert UNet(UNetConfig(**UNET_KW, remat_blocks=True)).cfg.remat_blocks
    with pytest.raises(NotImplementedError):
        UNet(UNetConfig(**UNET_KW, remat_blocks=True, w_pack_channels=128))
    with pytest.raises(NotImplementedError):
        DAE(DAEConfig(**DAE_KW, w_pack_channels=128))
