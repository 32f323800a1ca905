"""The port's sequence parallelism on the CPU: the DAE encode and decode with
the W axis split over 2 and 4 gloo ranks and halos exchanged between
neighbours, against JAX's ``sharded_tiled_encode`` and
``sharded_tiled_decode`` on meshes of as many devices (edges included) and
against the port's unsharded encode and decode in the interior. The ranks
are spawned once for the module. The DAE is JAX test_parallel.py's in an
fp32 trunk, where the two packages differ by fp32 rounding alone.

<-> dualdiffusion_tpu/parallel/sharded_ops.py and tests/test_parallel.py
(test_sharded_encode_matches_unsharded, test_sharded_decode_matches_unsharded).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_ranks as ranks
from dualdiffusion_tpu.models.dae import DAE as JaxDAE
from dualdiffusion_tpu.models.dae import DAEConfig as JaxDAEConfig
from dualdiffusion_tpu.parallel import sharded_tiled_decode as jax_sharded_decode
from dualdiffusion_tpu.parallel import sharded_tiled_encode as jax_sharded_encode
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu_torch.models import DAE, DAEConfig
from dualdiffusion_tpu_torch.parallel import (Axis, dae_halos, gather_w, shard_w,
                                              sharded_tiled_decode, sharded_tiled_encode)
from dualdiffusion_tpu_torch.weights import load_flat
from test_torch_pipeline_parallel import _seeded_vars

WORLD = 4
SIZES = (2, WORLD)
DAE_KW = dict(model_channels=8, channel_mult_enc=(1, 2), channel_mult_dec=(1, 2),
              num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=4,
              compute_dtype="float32")
HALO, HALO_LATENT = 32, 16          # JAX's test's: past the receptive-field radius
EDGE_LATENT, EDGE = 8, 64           # the interior starts this far from the clip's edges
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("sharded_dae")
    key = jax.random.PRNGKey(0)
    jdae = JaxDAE(JaxDAEConfig(**DAE_KW))
    x = jax.random.normal(key, (1, 16, 512, 2))
    v = _seeded_vars(jdae, np.random.default_rng(0), x)
    ds = jdae.downsample_ratio

    def enc(v_, chunk):
        return jdae.apply(v_, chunk, method=JaxDAE.encode)

    def dec(v_, lat):
        return jdae.apply(v_, lat, method=JaxDAE.decode)

    latents = jax.jit(enc)(v, x)
    want = {}
    for n in SIZES:
        mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
        want[n] = {"encode": np.asarray(jax.jit(lambda v_, x_: jax_sharded_encode(
                       enc, v_, x_, mesh, halo=HALO, downsample_ratio=ds))(v, x)),
                   "decode": np.asarray(jax.jit(lambda v_, l_: jax_sharded_decode(
                       dec, v_, l_, mesh, halo_latent=HALO_LATENT, downsample_ratio=ds))(
                       v, latents))}
    dae = DAE(DAEConfig(**DAE_KW)).eval()
    load_flat(dae, _flatten(v))
    inp = {"dae_kw": DAE_KW, "state": dae.state_dict(), "sizes": [n for n in SIZES if n < WORLD],
           "x": torch.from_numpy(np.array(x)), "latents": torch.from_numpy(np.array(latents)),
           "halo": HALO, "halo_latent": HALO_LATENT}
    torch.save(inp, tmp / "dae_inputs.pt")
    ranks.spawn(ranks.sharded_dae_runs, WORLD, tmp)
    return dae, inp, want, torch.load(tmp / "dae_out.pt", weights_only=False)


@pytest.mark.parametrize("op", ["encode", "decode"])
@pytest.mark.parametrize("n", SIZES)
def test_sharded_dae_matches_jax(runs, n, op):
    """Each rank's shard with its neighbours' halos, gathered, against JAX's
    shard_map on a mesh of n devices, everywhere: the clip's true edges see
    zero halos in both."""
    _, _, want, got = runs
    assert got[n][op].shape == want[n][op].shape
    np.testing.assert_allclose(got[n][op].numpy(), want[n][op], **TOL)


@pytest.mark.parametrize("op", ["encode", "decode"])
@pytest.mark.parametrize("n", SIZES)
def test_sharded_dae_matches_unsharded_in_the_interior(runs, n, op):
    """Against the port's unsharded encode and decode: equal in the interior,
    the seams between shards included; bounded within the receptive-field
    radius of the clip's true edges, where zero halos are not per-layer
    padding, by the output's own largest magnitude (JAX's test bounds its
    encode's alone, by an absolute 2.0)."""
    dae, inp, _, got = runs
    with torch.no_grad():
        whole = dae.encode(inp["x"]) if op == "encode" else dae.decode(inp["latents"])
    edge = EDGE_LATENT if op == "encode" else EDGE
    a, b = got[n][op].numpy(), whole.numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(a[:, :, edge:-edge], b[:, :, edge:-edge], **TOL)
    assert 0 < np.abs(a - b).max() <= np.abs(b).max()


def test_sharded_dae_over_one_rank_is_zero_padding(runs):
    """Over one rank both halos are zeros: the encode of the zero-extended
    mel with the halo's latents cut off."""
    dae, inp, _, _ = runs
    x = inp["x"]
    with torch.no_grad():
        got = sharded_tiled_encode(dae.encode, x, Axis(), HALO, dae.downsample_ratio)
        pad = x.new_zeros(x.shape[:2] + (HALO,) + x.shape[3:])
        h = HALO // dae.downsample_ratio
        want = dae.encode(torch.cat([pad, x, pad], dim=2))[:, :, h:-h]
    assert torch.equal(got, want)


@pytest.mark.parametrize("op", ["encode", "decode"])
def test_sharded_dae_at_zero_halo_is_each_shard_alone(runs, op):
    """At halo 0 each of two ranks returns exactly the encode (decode) of its
    own shard alone. JAX's ``x_shard[:, :, -halo:]`` is the whole shard at
    halo 0, so JAX would put both neighbours' whole shards around each
    shard; the port sends nothing (a reference fault it repairs)."""
    zero = runs[3]["zero_halo"]
    assert zero[op].shape == runs[3][2][op].shape
    assert torch.equal(zero[op], zero[f"{op}_alone"])
    assert not torch.equal(zero[op], runs[3][2][op])


def test_shard_w_and_gather_w_round_trip():
    x = torch.randn(1, 3, 12, 2)
    assert torch.equal(shard_w(x, Axis(None, 2, 3)), x[:, :, 8:12])
    assert torch.equal(gather_w(x, Axis()), x)
    with pytest.raises(ValueError, match="does not divide"):
        shard_w(x, Axis(None, 0, 5))


def test_sharded_dae_checks_are_jax_s():
    """JAX's two checks (the halo a multiple of the downsample ratio, W a
    multiple of shards x ds), and a halo wider than a shard."""
    x = torch.zeros(1, 4, 64, 2)
    with pytest.raises(ValueError, match="multiple of the downsample ratio"):
        sharded_tiled_encode(lambda t: t, x, Axis(), 6, 4)
    with pytest.raises(ValueError, match="must divide evenly"):
        sharded_tiled_encode(lambda t: t, x[:, :, :62], Axis(), 8, 4)
    with pytest.raises(ValueError, match="does not fit a shard"):
        sharded_tiled_decode(lambda t: t, x, Axis(), 65, 4)


def _changed(fn, x, cols, out_cols) -> bool:
    """Whether ``fn``'s output columns ``out_cols`` move when input columns
    ``cols`` get noise."""
    y = x.clone()
    y[:, :, cols] += torch.randn(y[:, :, cols].shape, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        return not torch.equal(fn(x)[:, :, out_cols], fn(y)[:, :, out_cols])


def test_dae_halos_are_the_receptive_field(runs):
    """``dae_halos`` of the test's DAE (ds 2): latent column i depends on mel
    columns within ``halo`` of its own ds columns and on none beyond, and a
    halo one ds narrower misses some; output columns ds i .. ds i + ds - 1
    depend on latent columns within ``halo_latent`` of i, the farthest
    included."""
    dae, inp, _, _ = runs
    ds = dae.downsample_ratio
    halo, halo_latent = dae_halos(dae.cfg)
    assert (halo, halo_latent) == (14, 8) and halo % ds == 0
    x, lat = inp["x"], inp["latents"]
    i = x.shape[2] // ds // 2
    first, last = ds * i - halo, ds * i + ds - 1 + halo
    beyond = list(range(first)) + list(range(last + 1, x.shape[2]))
    assert not _changed(dae.encode, x, beyond, [i])
    near = list(range(first, first + ds)) + list(range(last - ds + 1, last + 1))
    assert _changed(dae.encode, x, near, [i])
    out = list(range(ds * i, ds * i + ds))
    beyond = list(range(i - halo_latent)) + list(range(i + halo_latent + 1, lat.shape[2]))
    assert not _changed(dae.decode, lat, beyond, out)
    assert _changed(dae.decode, lat, [i - halo_latent, i + halo_latent], out)
