"""The port's dataset scrapers module against the JAX package's, on local
files only: archive extraction, folder comparison, the file-type census,
SPC tag reading and fixing (text and binary id666, xid6, APEv2, trees), and
the web scrapers' refusal offline. No test opens a network connection:
both packages' DNS probe is replaced by one that fails.

<-> dualdiffusion_tpu/dataset/scrapers.py.
"""

import socket
import zipfile

import pytest

from dualdiffusion_tpu.dataset import scrapers as jscrapers
from dualdiffusion_tpu_torch.dataset import scrapers


def _make_spc(length_field: bytes, fade_field: bytes, binary_artist: bool,
              xid6_fade_ticks=None, apev2=None) -> bytes:
    """A minimal SPC file with the given id666 fields, an optional xid6
    fade subchunk and optional APEv2 items."""
    data = bytearray(b"\x00" * 66048)
    data[0:27] = b"SNES-SPC700 Sound File Data"
    data[35] = 26
    data[169:169 + len(length_field)] = length_field
    data[172:172 + len(fade_field)] = fade_field
    if binary_artist:
        data[176] = 7
    if xid6_fade_ticks is not None:
        sub = bytes([51, 1]) + (4).to_bytes(2, "little") + int(xid6_fade_ticks).to_bytes(4, "little")
        data += b"xid6" + len(sub).to_bytes(4, "little") + sub
    if apev2 is not None:
        items = b""
        for key, val in apev2.items():
            v = str(val).encode()
            items += len(v).to_bytes(4, "little") + b"\x00" * 4 + key.encode() + b"\x00" + v
        data += (b"APETAGEX" + (2000).to_bytes(4, "little") + len(items).to_bytes(4, "little")
                 + len(apev2).to_bytes(4, "little") + b"\x00" * 12 + items)
    return bytes(data)


SPC_CASES = {
    "text": dict(length_field=b"30\x00", fade_field=b"8000\x00", binary_artist=False),
    "binary": dict(length_field=(30).to_bytes(3, "little"), fade_field=(8000).to_bytes(4, "little"),
                   binary_artist=True),
    "jingle": dict(length_field=b"10\x00", fade_field=b"0\x00\x00\x00\x00", binary_artist=False),
    "five_digit_fade": dict(length_field=b"30\x00", fade_field=b"10000", binary_artist=False),
    "zero_length": dict(length_field=b"0\x00\x00", fade_field=b"0\x00", binary_artist=False),
    "xid6_apev2": dict(length_field=b"30\x00", fade_field=b"8000\x00", binary_artist=False,
                       xid6_fade_ticks=8000 * 64, apev2={"spc_length": 30000, "spc_fade": 8000}),
}


@pytest.mark.parametrize("case", sorted(SPC_CASES))
@pytest.mark.parametrize("fade_ms", [0, 12000, None])
def test_spc_read_and_fix_match_jax(tmp_path, case, fade_ms):
    """Each package fixes its own copy: the same tags before and after, the
    same return value and the same bytes, and a second fix changes nothing."""
    raw = _make_spc(**SPC_CASES[case])
    paths = {}
    for pkg in ("jax", "port"):
        paths[pkg] = tmp_path / f"{pkg}.spc"
        paths[pkg].write_bytes(raw)
    assert scrapers.spc_read_tags(str(paths["port"])) == jscrapers.spc_read_tags(str(paths["jax"]))
    if case == "xid6_apev2" and fade_ms == 12000:
        # the 4-byte APEv2 fade item cannot hold "12000": JAX asserts, the
        # port raises ValueError (an assert is gone under python -O); no write
        with pytest.raises(AssertionError):
            jscrapers.spc_fix(str(paths["jax"]), min_length_s=50, fade_ms=fade_ms)
        with pytest.raises(ValueError, match="does not fit"):
            scrapers.spc_fix(str(paths["port"]), min_length_s=50, fade_ms=fade_ms)
        assert paths["port"].read_bytes() == paths["jax"].read_bytes() == raw
        return
    changed = jscrapers.spc_fix(str(paths["jax"]), min_length_s=50, fade_ms=fade_ms)
    assert scrapers.spc_fix(str(paths["port"]), min_length_s=50, fade_ms=fade_ms) == changed
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    assert scrapers.spc_read_tags(str(paths["port"])) == jscrapers.spc_read_tags(str(paths["jax"]))
    assert not scrapers.spc_fix(str(paths["port"]), min_length_s=50, fade_ms=fade_ms)


def test_spc_fix_tree_and_refusal_match_jax(tmp_path):
    for pkg in ("jax", "port"):
        for name, case in SPC_CASES.items():
            p = tmp_path / pkg / "sub" / f"{name}.spc"
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(_make_spc(**case))
    want = jscrapers.spc_fix_tree(str(tmp_path / "jax"), min_length_s=50, fade_ms=0)
    assert scrapers.spc_fix_tree(str(tmp_path / "port"), min_length_s=50, fade_ms=0) == want
    assert want[0] == len(SPC_CASES)
    for name in SPC_CASES:
        assert ((tmp_path / "port" / "sub" / f"{name}.spc").read_bytes()
                == (tmp_path / "jax" / "sub" / f"{name}.spc").read_bytes())
    bad = tmp_path / "bad.spc"
    bad.write_bytes(b"not an spc" * 10)
    for fn in (scrapers.spc_read_tags, scrapers.spc_fix):
        with pytest.raises(ValueError, match="not an SPC file"):
            fn(str(bad))


def test_local_utilities_match_jax(tmp_path):
    """extract_archives, compare_folders and list_file_types on the same
    trees (each package extracts its own copy)."""
    for pkg in ("jax", "port"):
        a, b = tmp_path / pkg / "a", tmp_path / pkg / "b"
        a.mkdir(parents=True)
        b.mkdir()
        (a / "x.txt").write_text("hello")
        (a / "y.wav").write_bytes(b"\x00" * 10)
        (b / "x.txt").write_text("hello world")
        (b / "z.flac").write_bytes(b"\x01")
        with zipfile.ZipFile(a / "arc.zip", "w") as z:
            z.writestr("inner.txt", "data")
            z.writestr("deep/more.wav", "wav")
    want = jscrapers.extract_archives(str(tmp_path / "jax" / "a"))
    got = scrapers.extract_archives(str(tmp_path / "port" / "a"))
    assert [p.replace("/port/", "/jax/") for p in got] == want and len(got) == 1
    assert (tmp_path / "port" / "a" / "arc" / "deep" / "more.wav").read_text() == "wav"
    got = scrapers.compare_folders(str(tmp_path / "port" / "a"), str(tmp_path / "port" / "b"))
    assert got == jscrapers.compare_folders(str(tmp_path / "jax" / "a"),
                                            str(tmp_path / "jax" / "b"))
    assert "y.wav" in got["only_a"] and "z.flac" in got["only_b"]
    assert got["size_mismatch"] == ["x.txt"]
    got = scrapers.list_file_types(str(tmp_path / "port"))
    assert got == jscrapers.list_file_types(str(tmp_path / "jax"))
    assert got[".txt"] == 3 and got[".zip"] == 1


@pytest.mark.parametrize("name", ["scrape_zophar", "scrape_joshw"])
def test_scrapers_refuse_offline(tmp_path, monkeypatch, name):
    """Both packages' scrapers raise when their DNS probe fails (here a
    probe that always fails, so nothing leaves the machine), and neither
    writes a file."""
    def no_dns(*args, **kwargs):
        raise OSError("no network in this test")

    monkeypatch.setattr(socket, "getaddrinfo", no_dns)
    monkeypatch.setattr(socket, "create_connection", no_dns)
    with pytest.raises(RuntimeError, match="zero-egress"):
        getattr(scrapers, name)("nes", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="zero-egress"):
        getattr(jscrapers, name)("nes", str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()
