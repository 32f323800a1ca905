"""DAE ``tiled_encode`` and both ``top_pca_components`` of the port against
the JAX package.

<-> dualdiffusion_tpu/models/dae.py ``tiled_encode`` (:336-375),
``top_pca_components`` (:378-396) and models/embeddings.py
``top_pca_components`` (:79-84).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.models.dae import DAE as JaxDAE
from dualdiffusion_tpu.models.dae import DAEConfig as JaxDAEConfig
from dualdiffusion_tpu.models.dae import tiled_encode as jax_tiled_encode
from dualdiffusion_tpu.models.dae import top_pca_components as jax_top_pca_components
from dualdiffusion_tpu.models.embeddings import top_pca_components as jax_emb_pca
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu_torch.models import (DAE, DAEConfig, tiled_encode, tiled_encode_plan,
                                            top_pca_components)
from dualdiffusion_tpu_torch.models.embeddings import top_pca_components as emb_pca
from dualdiffusion_tpu_torch.weights import load_flat

# three levels: downsample ratio 4; fp32 trunks in both packages
DAE_KW = dict(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
              num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8,
              in_num_freqs=16, compute_dtype="float32")
MAX_CHUNK, OVERLAP = 256, 32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_dae():
    jdae = JaxDAE(JaxDAEConfig(**DAE_KW))
    return jdae, jax.jit(jdae.init)(jax.random.PRNGKey(4), jnp.zeros((1, 16, 64, 2)))


def _port_dae(jvars) -> DAE:
    dae = DAE(DAEConfig(**DAE_KW)).eval()
    load_flat(dae, _flatten(jvars))
    return dae


class _ChunkStub:
    """Stands in for a DAE: the "latents" of a chunk are its mean over each
    ``ds`` columns plus 1000 times the chunk's width, so the tiled output
    shows which chunk every column came from."""
    downsample_ratio = 4

    class cfg:
        latent_channels = 2

    def encode(self, x, emb=None):
        b, h, w, c = x.shape
        ds = self.downsample_ratio
        pooled = x.reshape(b, h // ds, ds, w // ds, ds, c).mean(dim=(2, 4))
        return pooled + 1000.0 * w


@pytest.mark.parametrize("width", [256, 260, 452, 1024, 1100])
def test_tiled_encode_plan_matches_jax(width):
    """The same chunks, seam columns and pulled-back last chunk: with a
    stub encoder whose output names its chunk, the two tiled outputs are
    equal. W 1024 takes six chunks, the last (960-1024, 64 < 3 x 32 frames)
    pulled back to start at 928."""
    x = np.random.default_rng(width).standard_normal((1, 8, width, 2)).astype(np.float32)
    stub = _ChunkStub()
    seen = []

    def jax_apply(params, chunk, emb):
        seen.append(chunk.shape[2])
        return jnp.asarray(stub.encode(torch.from_numpy(np.array(chunk))).numpy())

    want = jax_tiled_encode(jax_apply, None, jnp.asarray(x), None, 4, 2, max_chunk=MAX_CHUNK,
                            overlap=OVERLAP)
    got = tiled_encode(stub, torch.from_numpy(x), None, MAX_CHUNK, OVERLAP)
    plan = tiled_encode_plan(width, 4, MAX_CHUNK, OVERLAP)
    assert [c1 - c0 for c0, c1, *_ in plan] == seen
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if width == 1024:
        assert len(plan) == 6 and plan[-1][:2] == (928, 1024)


class _Bf16Stub(_ChunkStub):
    """The chunk stub with a bf16 trunk's output dtype."""

    def encode(self, x, emb=None):
        return super().encode(x, emb).bfloat16()


@pytest.mark.parametrize("width", [256, 1024])
def test_tiled_encode_returns_fp32_for_any_chunk_count(width):
    """A bf16 trunk's latents come back fp32 whether the mel fits in one
    chunk (W 256) or takes six (W 1024)."""
    x = torch.from_numpy(np.random.default_rng(width).standard_normal((1, 8, width, 2))
                         .astype(np.float32))
    got = tiled_encode(_Bf16Stub(), x, None, MAX_CHUNK, OVERLAP)
    assert got.dtype == torch.float32 and got.shape == (1, 2, width // 4, 2)


def test_tiled_encode_plan_refuses_unaligned_widths():
    with pytest.raises(ValueError):
        tiled_encode_plan(1026, 4, MAX_CHUNK, OVERLAP)


def test_tiled_encode_matches_jax():
    """The tiny DAE in fp32 at W 1024 over six chunks: JAX's tiled output
    and the port's agree to fp32 rounding through ~10 convs (1e-4 of max,
    as the DAE decode parity test); the port's tiled and untiled encodes
    agree to the JAX test's median |d| < 1e-4 (the seams differ through
    conv padding)."""
    jdae, jvars = _jax_dae()
    x = np.random.default_rng(5).standard_normal((2, 16, 1024, 2)).astype(np.float32)

    def enc(v, chunk, emb):
        return jdae.apply(v, chunk, emb, method=JaxDAE.encode)

    want = np.asarray(jax_tiled_encode(jax.jit(enc), jvars, jnp.asarray(x), None, 4, 8,
                                       max_chunk=MAX_CHUNK, overlap=OVERLAP))
    dae = _port_dae(jvars)
    got = tiled_encode(dae, torch.from_numpy(x), None, MAX_CHUNK, OVERLAP)
    assert got.shape == want.shape == (2, 4, 256, 8) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    with torch.no_grad():
        full = dae.encode(torch.from_numpy(x))
    assert np.median(np.abs(got.numpy() - full.numpy())) < 1e-4


def _align_signs(got, want):
    """Flip each component of ``got`` to the sign under which it best
    matches ``want`` (singular vectors have no fixed sign)."""
    signs = np.sign(np.sum(got * want, axis=tuple(range(got.ndim - 1)), keepdims=True))
    return got * signs


def test_dae_top_pca_components_matches_jax():
    """Per-sample PCA of (B, H, W, C) latents: the same projections up to
    each component's sign, per sample (1e-4 of max, fp32 SVDs)."""
    rng = np.random.default_rng(6)
    base = rng.standard_normal((2, 8, 16, 1))
    x = (base * np.array([3.0, -2.0, 1.0, 0.5]) + 0.3 * rng.standard_normal((2, 8, 16, 4)))
    x = x.astype(np.float32)
    want = np.asarray(jax_top_pca_components(jnp.asarray(x), n_pca=3))
    got = top_pca_components(torch.from_numpy(x), n_pca=3).numpy()
    assert got.shape == want.shape == (2, 8, 16, 3)
    for b in range(2):
        assert np.abs(_align_signs(got[b], want[b]) - want[b]).max() < 1e-4 * np.abs(want).max()


def test_embedding_top_pca_components_matches_jax():
    """(N, D) -> (k, D) principal directions, each up to its sign."""
    e = np.random.default_rng(7).standard_normal((40, 16)).astype(np.float32)
    e[:, 0] *= 5.0
    want, got = jax_emb_pca(e, 4), emb_pca(e, 4)
    assert got.shape == want.shape == (4, 16)
    signs = np.sign(np.sum(got * want, axis=1, keepdims=True))
    np.testing.assert_allclose(got * signs, want, atol=1e-6)
