"""The port's native FLAC tag editor and WAV sidecar
(``dualdiffusion_tpu_torch/utils/audio_metadata.py``): the FLAC and WAV cases
of tests/test_audio_metadata.py on the port, and cross-reads: a file tagged
by one package reads the same in the other, and the same edits write the
same bytes."""

import json

import pytest

from dualdiffusion_tpu.utils import audio_metadata as jax_meta
from dualdiffusion_tpu_torch.utils import (AudioInfo, get_audio_info, get_audio_metadata,
                                           is_flac_file, update_audio_metadata)
from test_audio_metadata import FRAMES, make_flac


def test_audio_info(tmp_path):
    p = tmp_path / "a.flac"
    make_flac(p, sample_rate=44100, channels=1, bits=24, num_samples=44100)
    assert is_flac_file(p)
    info = get_audio_info(p)
    assert info == AudioInfo(44100, 1, 24, 44100)
    assert info.duration == 1.0
    assert not is_flac_file(tmp_path / "missing.flac")


def test_rating_round_trip_preserves_audio(tmp_path):
    p = tmp_path / "a.flac"
    make_flac(p, tags={"game": "chrono", "clap_score": "0.5"})
    update_audio_metadata(p, metadata={"song": "frog theme"}, rating=4,
                          clear_clap_fields=True)
    tags = get_audio_metadata(p)
    assert tags["RATING"] == ["4"]
    assert tags["RATING WMP"] == ["4"]
    assert tags["FMPS_RATING"] == ["0.8"]
    assert tags["song"] == ["frog theme"]
    assert tags["game"] == ["chrono"]
    assert "clap_score" not in tags
    assert open(p, "rb").read().endswith(FRAMES)
    assert get_audio_info(p).sample_rate == 32000


def test_update_overwrites_case_insensitively(tmp_path):
    p = tmp_path / "a.flac"
    make_flac(p, tags={"Rating": "1"})
    update_audio_metadata(p, rating=5, copy_on_write=True)
    tags = get_audio_metadata(p)
    assert tags["RATING"] == ["5"] and "Rating" not in tags
    assert not (tmp_path / "a.flac.tmp").exists()


def test_insert_comment_block_when_absent(tmp_path):
    p = tmp_path / "a.flac"
    make_flac(p)
    assert get_audio_metadata(p) == {}
    update_audio_metadata(p, metadata={"prompt": "jazz", "n": 3})
    tags = get_audio_metadata(p)
    assert tags["prompt"] == ["jazz"] and tags["n"] == ["3"]


def test_sidecar_fallback_for_wav(tmp_path):
    p = tmp_path / "a.wav"
    p.write_bytes(b"RIFF....WAVE")
    update_audio_metadata(p, rating=2, metadata={"clap_x": "1"})
    update_audio_metadata(p, clear_clap_fields=True)
    tags = get_audio_metadata(p)
    assert tags["RATING"] == ["2"] and "clap_x" not in tags
    assert json.loads((tmp_path / "a.wav.json").read_text())["RATING"] == "2"


def test_truncated_flac_raises(tmp_path):
    p = tmp_path / "a.flac"
    make_flac(p)
    p.write_bytes(p.read_bytes()[:20])
    with pytest.raises(ValueError, match="truncated"):
        get_audio_metadata(p)


EDITS = [dict(metadata={"song": "frog theme"}, rating=4, clear_clap_fields=True),
         dict(rating=0, copy_on_write=True),
         dict(metadata={"prompt": json.dumps({"a": 1.0}), "seed": 123456})]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("suffix", [".flac", ".wav"])
def test_cross_reads(tmp_path, writer, suffix):
    """Each edit applied by one package: the other reads the same tags, and
    the file (FLAC) or sidecar (WAV) is byte-identical to the one the other
    package writes from the same start."""
    update = {"port": update_audio_metadata, "jax": jax_meta.update_audio_metadata}
    other = "jax" if writer == "port" else "port"
    paths = {k: tmp_path / k / f"a{suffix}" for k in ("port", "jax")}
    for p in paths.values():
        p.parent.mkdir()
        if suffix == ".flac":
            make_flac(p, tags={"game": "chrono", "clap_score": "0.5"})
        else:
            p.write_bytes(b"RIFF....WAVE")
    for edit in EDITS:
        update[writer](paths[writer], **edit)
        update[other](paths[other], **edit)
        assert get_audio_metadata(paths[writer]) == jax_meta.get_audio_metadata(paths[writer])
        on_disk = (lambda p: p.read_bytes()) if suffix == ".flac" else \
            (lambda p: (p.parent / (p.name + ".json")).read_bytes())
        assert on_disk(paths["port"]) == on_disk(paths["jax"])
    tags = jax_meta.get_audio_metadata(paths["port"])
    assert tags["RATING"] == ["0"] and tags["song"] == ["frog theme"]
    assert tags["seed"] == ["123456"] and "clap_score" not in tags
    if suffix == ".flac":
        assert paths["port"].read_bytes().endswith(FRAMES)
        assert vars(get_audio_info(paths["jax"])) == vars(jax_meta.get_audio_info(paths["port"]))
