"""The legacy VAE, the discriminator, their module types in the pipeline,
and the converters of the reference's torch checkpoints, against the JAX
package on the CPU, with JAX's weights carried across by ``weights.py``.

<-> dualdiffusion_tpu/models/vae.py, dualdiffusion_tpu/models/
discriminator.py, dualdiffusion_tpu/pipelines/pipeline.py:61-69,
dualdiffusion_tpu/models/convert.py:85-247.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from dualdiffusion_tpu.models import convert as jconvert
from dualdiffusion_tpu.models.dae import DAE as JaxDAE
from dualdiffusion_tpu.models.dae import DAEConfig as JaxDAEConfig
from dualdiffusion_tpu.models.discriminator import Discriminator as JaxDisc
from dualdiffusion_tpu.models.discriminator import DiscriminatorConfig as JaxDiscConfig
from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from dualdiffusion_tpu.models.vae import VAE as JaxVAE
from dualdiffusion_tpu.models.vae import VAEConfig as JaxVAEConfig
from dualdiffusion_tpu.pipelines import pipeline as jpipeline
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu_torch.models import (DAE, VAE, DAEConfig, Discriminator,
                                            DiscriminatorConfig, UNet, UNetConfig, VAEConfig)
from dualdiffusion_tpu_torch.models import convert as tconvert
from dualdiffusion_tpu_torch.pipelines import pipeline as tpipeline
from dualdiffusion_tpu_torch.utils import config_to_dict
from dualdiffusion_tpu_torch.weights import load_flat, state_to_flat, to_flat
from test_torch_dae_training import DAE_KW
from test_torch_training import UNET_KW, X_SHAPE, set_trunk_dtype

VAE_KW = dict(model_channels=8, channel_mult=(1, 2), num_layers_per_block=1, label_dim=16,
              latent_channels=4)
DISC_KW = dict(in_channels_emb=16, model_channels=8, channel_mult_emb=2, num_layers=2)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel_l2(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _draw_like(shapes, seed):
    """Numpy draws in the shapes of a JAX init traced (not compiled): unit
    normal weights, gains near 1, balances and logvars near 0."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if leaf.ndim == 0:
            lo, hi = (0.5, 1.5) if "gain" in name else (-0.5, 0.5)
            return jnp.asarray(rng.uniform(lo, hi), leaf.dtype)
        return jnp.asarray(rng.standard_normal(leaf.shape), leaf.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_vae_matches_jax():
    """encode (mean, noise logvar, kl), get_embeddings, decode, and the
    training forward with a sampled latent (JAX's normal draw injected),
    fp32 to 1e-5 relative L2."""
    jvae = JaxVAE(JaxVAEConfig(**VAE_KW))
    x, emb_in = _x((2, 16, 12, 2), 1), _x((2, 16), 2)
    jv = _draw_like(jax.eval_shape(lambda k: jvae.init(k, jnp.zeros(x.shape), jnp.zeros((2, 16)),
                                                       method=JaxVAE.init_all),
                                   jax.random.PRNGKey(0)), 3)
    tvae = VAE(VAEConfig(**VAE_KW))
    load_flat(tvae, _flatten(jv))
    key = jax.random.PRNGKey(5)

    @jax.jit
    def jax_all(v, x, e):
        emb = jvae.apply(v, e, method=JaxVAE.get_embeddings)
        dist = jvae.apply(v, x, emb, method=JaxVAE.encode)
        lat, recon, _ = jvae.apply(v, x, emb, key, training=True)
        return emb, dist.mean, dist.logvar, dist.kl(), jvae.apply(v, dist.mean, emb,
                                                                  method=JaxVAE.decode), lat, recon
    want = jax_all(jv, jnp.asarray(x), jnp.asarray(emb_in))
    emb = tvae.get_embeddings(torch.from_numpy(emb_in))
    dist = tvae.encode(torch.from_numpy(x), emb)
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, dist.mean.shape)))
    lat, recon, _ = tvae(torch.from_numpy(x), emb, noise=noise, training=True)
    got = (emb, dist.mean, dist.logvar, dist.kl(), tvae.decode(dist.mean, emb), lat, recon)
    for g, w in zip(got, want):
        assert rel_l2(g, w) <= 1e-5
    assert tvae.get_latent_shape(x.shape) == jvae.get_latent_shape(x.shape)
    assert tvae.get_target_snr() == 32.0 and float(tvae.get_recon_loss_logvar()) == float(
        jv["params"]["recon_loss_logvar"])


def test_vae_init_matches_jax_scalars():
    """The scalar parameters' init (the latents' gain at the target std)."""
    jvae = JaxVAE(JaxVAEConfig(**VAE_KW))
    jv = jax.jit(lambda k: jvae.init(k, jnp.zeros((1, 16, 12, 2))))(jax.random.PRNGKey(0))
    tvae = VAE(VAEConfig(**VAE_KW)).init_weights(torch.Generator().manual_seed(0))
    got = to_flat(tvae)
    for k, w in _flatten(jv).items():
        if w.size == 1:
            assert np.allclose(got[k], w), k


@pytest.mark.parametrize("with_emb", [True, False])
def test_discriminator_matches_jax(with_emb):
    """(logits_map, hidden_kld) on stereo-folded (B, 2, H, W, 1) samples, the
    rank-3 (1, 3, 3) convs W reflect padded, with and without the label
    embedding (a JAX init without one has no label weights: the port loads
    it with fresh ones it does not use): fp32 to 1e-5 relative L2."""
    jdisc = JaxDisc(JaxDiscConfig(**DISC_KW))
    x, emb_in = _x((2, 2, 16, 12, 1), 10), _x((2, 16), 11)
    init = (lambda k: jdisc.init(k, jnp.zeros(x.shape), jnp.zeros((2, 16)),
                                 method=JaxDisc.init_all)) if with_emb else (
        lambda k: jdisc.init(k, jnp.zeros(x.shape)))
    jv = _draw_like(jax.eval_shape(init, jax.random.PRNGKey(0)), 12)
    tdisc = Discriminator(DiscriminatorConfig(**DISC_KW))
    load_flat(tdisc, _flatten(jv))

    @jax.jit
    def jax_fwd(v, x, e):
        emb = jdisc.apply(v, e, method=JaxDisc.get_embeddings) if with_emb else None
        return jdisc.apply(v, x, emb)
    want = jax_fwd(jv, jnp.asarray(x), jnp.asarray(emb_in))
    emb = tdisc.get_embeddings(torch.from_numpy(emb_in)) if with_emb else None
    got = tdisc(torch.from_numpy(x), emb)
    assert got[0].shape == (2, 2, 16, 12, 1)
    for g, w in zip(got, want):
        assert rel_l2(g, w) <= 1e-5


def test_vae_and_disc_pipeline_round_trip(tmp_path):
    """A model directory with "vae" and "disc" modules: the port writes it,
    ``from_pretrained`` loads it back equal, JAX's ``load_module`` reads the
    same weights from it; an unknown module type is refused with JAX's
    error text (the registries hold the same types)."""
    vcfg, dcfg = VAEConfig(**VAE_KW), DiscriminatorConfig(**DISC_KW)
    g = torch.Generator().manual_seed(0)
    vae, disc = VAE(vcfg).init_weights(g), Discriminator(dcfg).init_weights(g)
    tpipeline.Pipeline({"vae": tpipeline.ModuleHandle("vae", "vae", vcfg, vae),
                        "disc": tpipeline.ModuleHandle("disc", "disc", dcfg, disc)}
                       ).save_pretrained(tmp_path)
    loaded = tpipeline.Pipeline.from_pretrained(tmp_path, device="cpu")
    for name, module in (("vae", vae), ("disc", disc)):
        h = loaded.modules[name]
        assert h.module_type == name and config_to_dict(h.config) == config_to_dict(module.cfg)
        want = to_flat(module)
        got = to_flat(h.module)
        assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
        jtype, _, jvars = jpipeline.load_module(tmp_path, name)
        assert jtype == name
        jflat = _flatten(jvars)
        assert jflat.keys() == want.keys() and all(np.array_equal(jflat[k], want[k]) for k in want)
    assert sorted(tpipeline.MODULE_REGISTRY) == sorted(jpipeline._MODULE_REGISTRY)
    with pytest.raises(KeyError) as want_err:
        jpipeline.get_module_class("gan")
    with pytest.raises(KeyError) as got_err:
        tpipeline.get_module_class("gan")
    assert str(got_err.value) == str(want_err.value)


# ---------------------------------------------------------------------------
# the reference-checkpoint converters
# ---------------------------------------------------------------------------

def _ref_unet_key(path) -> str:
    """A flax path of the UNet as the reference names it: the inverse of JAX
    ``_torch_key_to_flax_path``'s grammar (convert.py:85-150)."""
    leaf = {"w_mp": "weight", "w_raw": "weight", "bias": "bias"}
    parts = list(path)
    tail = [leaf.get(parts[-1], parts[-1])]
    if parts[0] == "core" and parts[1] == "enc_conv_in":
        return ".".join(["enc", "conv_in"] + parts[2:-1] + tail)
    if parts[0] == "core":
        m = re.fullmatch(r"(enc|dec)_b(\d+)_(down|up|in0|in1|l\d+)", parts[1])
        if m:
            kind = m.group(3)
            block = f"block{m.group(2)}_" + (f"layer{kind[1:]}" if kind[0] == "l" else kind)
            return ".".join([m.group(1), block] + parts[2:-1] + tail)
        return ".".join(parts[1:-1] + tail)
    return ".".join(parts[:-1] + tail)


def _ref_dae_key(path, enc_names, dec_names) -> str:
    leaf = {"w_mp": "weight", "bias": "bias"}
    parts = list(path)
    tail = [leaf.get(parts[-1], parts[-1])]
    m = re.fullmatch(r"(enc|dec)_(\d+)", parts[0])
    if m:
        names = enc_names if m.group(1) == "enc" else dec_names
        return ".".join([m.group(1), names[int(m.group(2))]] + parts[1:-1] + tail)
    if parts[0] == "conv_in":
        return "enc.conv_in." + tail[0]
    return ".".join(parts[:-1] + tail)


def test_torch_unet_converter_matches_jax(monkeypatch):
    """A reference-named UNet state dict built from JAX's grammar (every key
    maps back through JAX ``_torch_key_to_flax_path``), plus the MPFourier
    buffers the converters skip: both converters fill their templates
    alike, and the two converted UNets' forwards agree (fp32 trunks, 1e-5
    relative L2). An unknown key and a missing one raise KeyError in both."""
    set_trunk_dtype(monkeypatch, "float32")
    junet = JaxUNet(JaxUNetConfig(**UNET_KW))
    init = (lambda k: junet.init(k, jnp.zeros((1,) + X_SHAPE[1:]), jnp.ones((1,)),
                                 jnp.zeros((1, 8)), method=JaxUNet.init_all))
    template = _draw_like(jax.eval_shape(init, jax.random.PRNGKey(0)), 20)
    source = _draw_like(jax.eval_shape(init, jax.random.PRNGKey(0)), 21)
    ref = {}
    for path, v in flatten_dict(source["params"]).items():
        key = _ref_unet_key(path)
        assert jconvert._torch_key_to_flax_path(key) == path, key
        ref[key] = np.asarray(v)
    ref["emb_noise.freqs"] = np.zeros(4, np.float32)
    ref["emb_noise.phases"] = np.zeros(4, np.float32)
    jvars = jconvert.torch_unet_state_to_variables(ref, template)
    tunet = UNet(UNetConfig(**UNET_KW))
    load_flat(tunet, _flatten(template))
    tunet.load_state_dict(tconvert.torch_unet_state_to_state(ref, tunet))
    assert all(np.array_equal(v, _flatten(jvars)[k]) for k, v in to_flat(tunet).items())
    rng = np.random.default_rng(22)
    x = rng.standard_normal(X_SHAPE).astype(np.float32)
    sigma = rng.uniform(0.1, 5, X_SHAPE[0]).astype(np.float32)
    emb_in = rng.standard_normal((X_SHAPE[0], 8)).astype(np.float32)
    mask = np.ones(X_SHAPE[0], np.float32)

    @jax.jit
    def jfwd(v):
        e = junet.apply(v, jnp.asarray(emb_in), jnp.asarray(mask), method=JaxUNet.get_embeddings)
        return junet.apply(v, jnp.asarray(x), jnp.asarray(sigma), e)
    want = jfwd(jvars)
    with torch.no_grad():
        e = tunet.get_embeddings(torch.from_numpy(emb_in), torch.from_numpy(mask))
        got = tunet(torch.from_numpy(x), torch.from_numpy(sigma), e)
    assert rel_l2(got, want) <= 1e-5
    for bad in ({**ref, "enc.block9_layer0.conv_res0.weight": ref["conv_out.weight"]},
                {k: v for k, v in ref.items() if k != "conv_out.weight"},
                {**ref, "mystery.weight": ref["conv_out.weight"]}):
        with pytest.raises(KeyError):
            jconvert.torch_unet_state_to_variables(bad, template)
        with pytest.raises(KeyError):
            tconvert.torch_unet_state_to_state(bad, tunet)


def test_torch_dae_converter_matches_jax():
    """A reference-named DAE (q4) state dict, its enc/dec blocks named by
    position as JAX convert.py:193-207 orders them, with the latent stats
    tracker the converters skip: both fill their templates alike (the stats
    stay the template's), and the converted DAEs encode and decode alike."""
    jdae = JaxDAE(JaxDAEConfig(**DAE_KW))
    init = lambda k: jdae.init(k, jnp.zeros((1, 64, 40, 2)))  # noqa: E731
    template = _draw_like(jax.eval_shape(init, jax.random.PRNGKey(0)), 30)
    source = _draw_like(jax.eval_shape(init, jax.random.PRNGKey(0)), 31)
    levels, n_enc, n_dec = 2, 1, 1
    enc_names = ["block0_layer0", "block1_down", "block1_layer0"]
    dec_names = ["block1_in0", "block1_layer0", "block0_up", "block0_layer0"]
    ref = {_ref_dae_key(p, enc_names, dec_names): np.asarray(v)
           for p, v in flatten_dict(source["params"]).items()}
    ref["latents_stats_tracker.running_mean"] = np.zeros(4, np.float32)
    jvars = jconvert.torch_dae_state_to_variables(ref, template, levels, n_enc, n_dec)
    tdae = DAE(DAEConfig(**DAE_KW))
    load_flat(tdae, _flatten(template))
    state = tconvert.torch_dae_state_to_state(ref, tdae, levels, n_enc, n_dec)
    got_flat = state_to_flat(state)
    assert all(np.array_equal(v, _flatten(jvars)[k]) for k, v in got_flat.items())
    tdae.load_state_dict(state)
    mel = _x((2, 64, 40, 2), 32)
    want = jax.jit(lambda v, m: jdae.apply(v, m, training=False))(jvars, jnp.asarray(mel))
    with torch.no_grad():
        got = tdae(torch.from_numpy(mel), training=False)
    for g, w in zip(got, want):
        assert rel_l2(g, w) <= 1e-5
    bad = {k: v for k, v in ref.items() if k != "out_gain"}
    with pytest.raises(KeyError):
        jconvert.torch_dae_state_to_variables(bad, template, levels, n_enc, n_dec)
    with pytest.raises(KeyError):
        tconvert.torch_dae_state_to_state(bad, tdae, levels, n_enc, n_dec)
