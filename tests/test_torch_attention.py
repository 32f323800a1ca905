"""The port's attention path against the JAX package on the CPU: K7's plain
version against the Pallas flash kernel (interpret mode), the SDPA routes,
sliding-window attention, the RoPE helpers, the UNet's "full" and "time"
attention axes and a tiny generate with "full" attention.

<-> dualdiffusion_tpu/ops/pallas/flash_attention.py,
dualdiffusion_tpu/models/attention.py and the attention block of
dualdiffusion_tpu/models/unet.py. Inputs come from numpy seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dualdiffusion_tpu.models.attention as jattn
import dualdiffusion_tpu_torch.models.attention as tattn
from dualdiffusion_tpu.models.dae import DAE as JaxDAE
from dualdiffusion_tpu.models.dae import DAEConfig as JaxDAEConfig
from dualdiffusion_tpu.models.formats import SpectrogramFormat as JaxSpectrogramFormat
from dualdiffusion_tpu.models.formats import SpectrogramFormatConfig as JaxFormatConfig
from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from dualdiffusion_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from dualdiffusion_tpu.pipelines.pipeline import ModuleHandle as JaxModuleHandle
from dualdiffusion_tpu.pipelines.pipeline import Pipeline as JaxPipeline
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu.sampling import SampleParams as JaxSampleParams
from dualdiffusion_tpu_torch.models import UNet, UNetConfig
from dualdiffusion_tpu_torch.ops.kernels import flash_attention, flash_attention_plain
from dualdiffusion_tpu_torch.pipelines import Pipeline
from dualdiffusion_tpu_torch.sampling import SampleParams
from dualdiffusion_tpu_torch.weights import load_flat
from test_torch_training import set_trunk_dtype

# the tiny UNet of tests/test_torch_models.py, attention at level 1
UNET_KW = dict(in_channels=8, out_channels=8, in_channels_emb=1024, model_channels=16,
               channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=16,
               logvar_channels=32, mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
DAE_KW = dict(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
              num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8)
FMT_KW = dict(window_duration_ms=40, padded_duration_ms=40, num_frequencies=64,
              default_raw_length=63 * 256)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


# ---------------------------------------------------------------------------
# K7's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l,d,window,causal,bq", [
    (256, 64, None, False, 128),     # multi-block dense
    (256, 64, None, True, 128),      # causal
    (384, 64, 64, False, 128),       # banded, multi k-block
    (100, 48, None, False, 256),     # unpadded L and D
    (300, 64, 40, False, 64),        # banded with L padding
    (64, 128, 16, True, 32),         # banded + causal
    (64, 32, 0, False, 32),          # each query sees its own key only
    (64, 32, 0, True, 32),
    (96, 8, None, False, 32),        # head widths the card pads in its loads: 8 -> 32
    (96, 24, 20, False, 32),         # 24 -> 32, banded
    (64, 192, None, True, 32),       # 192 -> 256 (JAX pads to 256 lanes)
    (64, 320, 24, False, 32),        # wider than 256: the card's D-chunked kernel (JAX: 384 lanes)
])
def test_flash_plain_matches_pallas_kernel(l, d, window, causal, bq):
    """fp32: the same softmax summed in another order (2e-5, the JAX
    kernel's own tolerance). The wrapper takes the plain version for CPU
    tensors and launches nothing."""
    q, k, v = _qkv(l + d, (2, 3, l, d))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                     causal=causal, block_q=bq, block_k=bq, interpret=True)
    before = flash_attention.launches
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), window=window, causal=causal)
    assert flash_attention.launches == before
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    plain = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), window=window,
                                  causal=causal)
    assert torch.equal(plain, got)


def test_flash_plain_bf16_io():
    """bf16 in and out: one bf16 rounding of the output (2e-2)."""
    q = jnp.asarray(np.random.default_rng(1).standard_normal((1, 2, 128, 64)), jnp.bfloat16)
    want = jax_flash(q, q, q, interpret=True)
    tq = torch.from_numpy(np.array(q.astype(jnp.float32))).bfloat16()
    got = flash_attention(tq, tq, tq)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_flash_wrapper_rejects_bad_arguments():
    q = torch.zeros((1, 2, 16, 32))
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :1], q)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, window=-1)


# ---------------------------------------------------------------------------
# SDPA routes, sliding-window attention, RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,causal,training", [
    (None, False, False), (None, True, False), (7, False, False), (7, True, True),
    (0, False, True)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_sdpa_matches_jax(window, causal, training, dtype, tol):
    """Both packages take the einsum route here (CPU, L < FLASH_MIN_SEQ).
    fp32: summation order (1e-5 of max); bf16: logits and probabilities
    rounded to bf16 in both, at different points (2e-2)."""
    q, k, v = _qkv(4, (2, 3, 40, 16))
    jdt = getattr(jnp, dtype)
    want = jattn.scaled_dot_product_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), scale=0.3, window=window, causal=causal,
        training=training)
    got = tattn.scaled_dot_product_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)), scale=0.3,
        window=window, causal=causal, training=training)
    assert got.dtype == getattr(torch, dtype)
    assert _rel_err(got.float().numpy(), np.asarray(want, np.float32)) < tol


@pytest.mark.parametrize("window,causal", [(None, False), (None, True), (5, False), (5, True)])
def test_einsum_route_matches_flash_plain(window, causal):
    """The port's two routes agree in fp32 (1e-5 of max): the dispatch may
    send a call to either."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, (1, 2, 64, 32)))
    got = tattn.einsum_attention(q, k, v, 0.2, window, causal)
    want = flash_attention_plain(q, k, v, 0.2, window, causal)
    assert _rel_err(got.numpy(), want.numpy()) < 1e-5


@pytest.mark.parametrize("causal", [False, True])
def test_sliding_window_attention_matches_jax(causal):
    q, k, v = _qkv(6, (1, 2, 200, 32))
    want = jattn.sliding_window_attention(*map(jnp.asarray, (q, k, v)), window_size=24,
                                          causal=causal)
    got = tattn.sliding_window_attention(*map(torch.from_numpy, (q, k, v)), window_size=24,
                                         causal=causal)
    assert _rel_err(got.numpy(), np.asarray(want)) < 1e-5


def test_sdpa_dispatch(monkeypatch):
    """K7 from FLASH_MIN_SEQ on the card and not in training; the einsum
    route otherwise (the JAX threshold, kept)."""
    assert tattn.FLASH_MIN_SEQ == jattn.FLASH_MIN_SEQ == 2048
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tattn._use_flash(2048, cuda) and not tattn._use_flash(2047, cuda)
    assert not tattn._use_flash(4096, cpu)
    calls = []

    def fake_flash(q, k, v, scale, window, causal):
        calls.append((scale, window, causal))
        return q
    monkeypatch.setattr(tattn, "flash_attention", fake_flash)
    monkeypatch.setattr(tattn, "_use_flash", lambda seq_len, device: True)
    q = torch.randn((1, 1, 8, 16))
    tattn.scaled_dot_product_attention(q, q, q, window=3, causal=True)
    assert calls == [(0.25, 3, True)]
    tattn.scaled_dot_product_attention(q, q, q, training=True)
    tattn.sliding_window_attention(q, q, q, window_size=2)
    assert calls == [(0.25, 3, True), (0.25, 2, False)]


@pytest.mark.parametrize("length,rope_ch,base,scale", [(17, 8, 10000.0, 1.0),
                                                       (40, 16, 500.0, 0.5), (5, 0, 1e4, 1.0)])
def test_rope_matches_jax(length, rope_ch, base, scale):
    """Tables: the same float64 math (exact). Rotation: fp32 products (1e-6)."""
    jc, js = jattn.build_rope_tables(length, rope_ch, base, scale)
    tc, ts = tattn.build_rope_tables(length, rope_ch, base, scale)
    assert np.array_equal(jc, tc) and np.array_equal(js, ts)
    x = np.random.default_rng(7).standard_normal((2, 3, length, 24)).astype(np.float32)
    want = jattn.rope_rotate_partial(jnp.asarray(x), jnp.asarray(jc), jnp.asarray(js))
    got = tattn.rope_rotate_partial(torch.from_numpy(x), torch.from_numpy(tc),
                                    torch.from_numpy(ts))
    assert _rel_err(got.numpy(), np.asarray(want)) < 1e-6


@pytest.mark.parametrize("n,t0,rope_ch", [(31, None, 2), (16, 3, 4), (24, 20, 2)])
def test_rope_self_test_matches_jax(n, t0, rope_ch):
    assert tattn.rope_self_test(n, t0, rope_ch) == jattn.rope_self_test(n, t0, rope_ch)
    assert tattn.rope_self_test(n, t0, rope_ch)


# ---------------------------------------------------------------------------
# the UNet's "full" and "time" attention axes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_unet_vars():
    """Weights of the tiny UNet (they do not depend on the attention axis),
    every zero-initialised gain given a value."""
    unet = JaxUNet(JaxUNetConfig(**UNET_KW, attn_axis="full"))
    v = jax.jit(lambda k: unet.init(k, jnp.zeros((1, 16, 32, 8)), jnp.ones((1,)),
                                    jnp.zeros((1, 1024)), method=JaxUNet.init_all))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def gains(path, leaf):
        return (jnp.asarray(rng.uniform(0.5, 1.5), leaf.dtype)
                if leaf.ndim == 0 and "gain" in getattr(path[-1], "key", "") else leaf)
    return jax.tree_util.tree_map_with_path(gains, v)


@pytest.mark.parametrize("axis", ["full", "time"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_unet_attention_axes_match_jax(axis, dtype, tol, monkeypatch):
    """The UNet forward with "full" (L = H*W = 128 at level 1) and "time"
    (L = W = 16) attention against JAX on the same weights. fp32 trunk:
    float rounding (1e-4 of max); bf16 trunk: the packages round at
    different places (3e-2)."""
    set_trunk_dtype(monkeypatch, dtype)
    junet = JaxUNet(JaxUNetConfig(**UNET_KW, attn_axis=axis))
    jvars = _jax_unet_vars()
    tunet = UNet(UNetConfig(**UNET_KW, attn_axis=axis)).eval()
    load_flat(tunet, _flatten(jvars))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 16, 32, 8)).astype(np.float32) * 3.0
    sigma = np.array([2.5, 0.7], np.float32)
    emb_in = rng.standard_normal((2, 1024)).astype(np.float32)
    mask = np.array([1.0, 0.0], np.float32)
    j_emb = junet.apply(jvars, jnp.asarray(emb_in), jnp.asarray(mask),
                        method=JaxUNet.get_embeddings)
    want = jax.jit(lambda v, a, s, e: junet.apply(v, a, s, e))(
        jvars, jnp.asarray(x), jnp.asarray(sigma), j_emb)
    with torch.no_grad():
        t_emb = tunet.get_embeddings(torch.from_numpy(emb_in), torch.from_numpy(mask))
        got = tunet(torch.from_numpy(x), torch.from_numpy(sigma), t_emb)
    c_skip = (1.0 / (sigma ** 2 + 1.0)).reshape(-1, 1, 1, 1)
    assert _rel_err(got.numpy() - c_skip * x, np.asarray(want) - c_skip * x) < tol


def test_unet_training_forward_takes_the_einsum_route(monkeypatch):
    """``training`` reaches the SDPA from every attention block, so a
    training forward never takes K7, which has no backward."""
    seen = []
    real = tattn.scaled_dot_product_attention

    def spy(q, k, v, scale=None, window=None, causal=False, training=False):
        seen.append(training)
        return real(q, k, v, scale, window, causal, training)
    import dualdiffusion_tpu_torch.models.unet as port_unet
    monkeypatch.setattr(port_unet, "scaled_dot_product_attention", spy)
    tunet = UNet(UNetConfig(**UNET_KW, attn_axis="full"))
    tunet.init_weights(torch.Generator().manual_seed(0))
    x, sigma = torch.randn((1, 16, 32, 8)), torch.ones((1,))
    tunet(x, sigma, None, training=True)
    with torch.no_grad():
        tunet(x, sigma, None)
    n = len(seen) // 2
    assert n > 0 and seen == [True] * n + [False] * n


# ---------------------------------------------------------------------------
# a tiny generate with "full" attention
# ---------------------------------------------------------------------------

def test_full_attention_generate_matches_jax(tmp_path):
    """``generate`` of a tiny model with "full" attention (L = 64 at level 1)
    against JAX ``generate``, the JAX key splits replayed as explicit noise
    (tests/test_torch_pipeline.py). Both run bf16 trunks: latents to 5e-2
    of max after two Heun steps, the mel to 6e-2 relative L2, the audio
    through its own mel spectrogram to 0.2 relative L2."""
    key_u, key_d = jax.random.split(jax.random.PRNGKey(12))
    ucfg, dcfg = JaxUNetConfig(**UNET_KW, attn_axis="full"), JaxDAEConfig(**DAE_KW)
    unet, dae = JaxUNet(ucfg), JaxDAE(dcfg)
    uvars = jax.jit(lambda k: unet.init(k, jnp.zeros((1, 16, 16, 8)), jnp.ones((1,)),
                                        jnp.zeros((1, 1024)), method=JaxUNet.init_all))(key_u)
    dvars = jax.jit(dae.init)(key_d, jnp.zeros((1, 64, 64, 2)))
    rng = np.random.default_rng(4)

    def gains(path, leaf):
        return (jnp.asarray(rng.uniform(0.5, 1.5), leaf.dtype)
                if leaf.ndim == 0 and "gain" in getattr(path[-1], "key", "") else leaf)
    uvars = jax.tree_util.tree_map_with_path(gains, uvars)
    fcfg = JaxFormatConfig(**FMT_KW)
    jpipe = JaxPipeline({
        "unet": JaxModuleHandle("unet", "unet", ucfg, unet, uvars),
        "dae": JaxModuleHandle("dae", "dae", dcfg, dae, dvars),
        "format": JaxModuleHandle("format", "format:spectrogram", fcfg,
                                  JaxSpectrogramFormat(fcfg))})
    jpipe.save_pretrained(tmp_path / "model")
    steps, iters = 2, 3
    key = jax.random.PRNGKey(3)
    prompt = np.random.default_rng(5).standard_normal((1, 1024)).astype(np.float32)
    want = jpipe.generate(JaxSampleParams(steps=steps, num_fgla_iters=iters), key,
                          prompt_embedding=jnp.asarray(prompt), decode_mode="fgla")

    k_loop, nk = jax.random.split(jax.random.split(key, 3)[0])
    lat_shape = tuple(want["latents"].shape)
    init = jax.random.normal(jax.random.split(nk)[0], lat_shape, jnp.float32)
    step_noise = []
    for _ in range(steps):
        k_loop, k_noise, _ = jax.random.split(k_loop, 3)
        step_noise.append(torch.from_numpy(np.array(
            jax.random.normal(jax.random.split(k_noise)[0], lat_shape, jnp.float32))))

    pipe = Pipeline.from_pretrained(tmp_path / "model", device="cpu")
    assert pipe.modules["unet"].config.attn_axis == "full"
    got = pipe.generate(SampleParams(steps=steps, num_fgla_iters=iters),
                        prompt_embedding=torch.from_numpy(prompt), decode_mode="fgla",
                        init_noise=torch.from_numpy(np.array(init)), step_noise=step_noise)

    def rel_l2(a, b):
        b = np.asarray(b, np.float32)
        return np.linalg.norm(a.float().numpy() - b) / np.linalg.norm(b)

    with torch.no_grad():
        out_mel = [pipe.format.raw_to_sample(torch.from_numpy(np.array(r)))
                   for r in (got["raw"], want["raw"])]
    assert got["raw"].shape == tuple(want["raw"].shape) == (1, 2, 63 * 256)
    assert _rel_err(got["latents"].float().numpy(), want["latents"]) < 5e-2
    assert rel_l2(got["sample"], want["sample"]) < 6e-2
    assert rel_l2(out_mel[0], out_mel[1].numpy()) < 0.2
