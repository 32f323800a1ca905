"""``correct`` at a tiny size on the CPU: a sound run of every cell comes
out correct under the cell's limits; the control (the reference in float8
in the port's place) and each fault a serving cell can have, planted in
the port underneath a run, come out not correct. The look for a card is
skipped (the runs are on the CPU); the rest of a run is driven whole."""

import pytest
import torch

from benchmark import common
from benchmark.run import measure
from benchmark.tests.tiny import tiny_root

CELLS = [w["name"] for w in common.benchmark_spec()["workloads"]]
SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def run(root, cell, **kw):
    return measure(common.benchmark_spec(root), cell, SEED, 0.0, 0, "cpu", root=root, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    out = run(root, cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    out = run(root, cell, control=True)
    assert not out["correct"], out["checks"]


def step_returns_its_state(monkeypatch):
    """Every denoiser step hands back its input: the sampler's state never
    moves toward the data."""
    import dualdiffusion_tpu_torch.pipelines.pipeline as pipeline
    real = pipeline.edm_sample

    def sample(denoise_fn, *a, **kw):
        return real(lambda x, sigma, *r: x, *a, **kw)
    monkeypatch.setattr(pipeline, "edm_sample", sample)


def half_the_batch_left_out(monkeypatch):
    """The latent stage samples the first half of the batch and hands it
    out again for the second half."""
    from dualdiffusion_tpu_torch.pipelines.pipeline import Pipeline
    real = Pipeline.diffusion_decode

    def decode(self, params, sample_shape, audio_embedding=None, *a, **kw):
        b = sample_shape[0]
        if kw.get("module_name", "unet") != "unet" or b < 2:
            return real(self, params, sample_shape, audio_embedding, *a, **kw)
        half = real(self, params, (b // 2,) + tuple(sample_shape[1:]),
                    audio_embedding[:b // 2], *a, **kw)
        return torch.cat([half, half[: b - b // 2]])
    monkeypatch.setattr(Pipeline, "diffusion_decode", decode)


def answer_altered(monkeypatch):
    """The audio comes out of its decode 10 % too quiet."""
    from dualdiffusion_tpu_torch.models.formats.ms_mdct_dual import MSMDCTDualFormat
    from dualdiffusion_tpu_torch.models.formats.spectrogram import SpectrogramFormat
    for cls, name in ((SpectrogramFormat, "sample_to_raw"), (MSMDCTDualFormat, "mdct_to_raw")):
        real = getattr(cls, name)
        monkeypatch.setattr(cls, name, lambda self, *a, _f=real, **kw: 0.9 * _f(self, *a, **kw))


FAULTS = {"step_returns_its_state": step_returns_its_state,
          "half_the_batch_left_out": half_the_batch_left_out,
          "answer_altered": answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    traffic = common.traffic_file(common.workload(common.benchmark_spec(root), cell)["traffic"],
                                  root / "benchmark")
    if fault == "half_the_batch_left_out" and traffic["batch"] < 2:
        pytest.skip("a batch of one has no half to leave out")
    FAULTS[fault](monkeypatch)
    out = run(root, cell)
    assert not out["correct"], out["checks"]
