"""The port's web UI (``dualdiffusion_tpu_torch/serving/webui.py``) against the
JAX package's: the output editor's latent/mask math, the preview images
(``tensor_to_img`` on both colormap branches, the PIL-free PNG encoder
decoded by PIL), the WAV bytes, the page (equal but for the ``esc()``
repair), and every GET route of both handlers over the same state, with no
server process behind them.
"""

import io
import json
import re
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

from dualdiffusion_tpu.serving import webui as jax_webui
from dualdiffusion_tpu.utils import roseus as jax_roseus
from dualdiffusion_tpu.utils import utils as jax_utils
from dualdiffusion_tpu_torch.serving import webui
from dualdiffusion_tpu_torch.utils import png_bytes, roseus, tensor_to_img


def _output(w, seed=5, n=32000):
    lat = 1.0 + np.arange(4 * w * 2, dtype=np.float32).reshape(1, 4, w, 2)
    rng = np.random.default_rng(seed)
    return {"latents": lat, "raw": 0.3 * rng.standard_normal((1, 2, n)).astype(np.float32),
            "sample": rng.standard_normal((1, 16, 40, 2)).astype(np.float32),
            "sample_rate": 32000, "seed": seed}


EDITS = [{"extend": "append"}, {"extend": "prepend"},
         {"inpaint_start": 0.0, "inpaint_end": 0.5}, {"inpaint_start": 0.25, "inpaint_end": 0.6},
         {"inpaint_start": "0.1", "inpaint_end": "2.0"}, {"inpaint_start": -1.0, "inpaint_end": 0.3},
         {"inpaint_start": 0.5, "inpaint_end": 0.5}, {"inpaint_start": 0.6, "inpaint_end": 0.2},
         {"img2img_strength": 0.4}]


@pytest.mark.parametrize("w", [7, 8])
@pytest.mark.parametrize("edit", EDITS, ids=lambda e: "-".join(f"{k}={v}" for k, v in e.items()))
def test_setup_editor_input_matches_jax(tmp_path, w, edit):
    """The latents and mask each edit writes to the server state, the params
    left behind, and the refusals (an empty range) are JAX's, exactly."""
    results = []
    for mod in (webui, jax_webui):
        ui = mod.UIState({"input_latents": "stale", "inpainting_mask": "stale"}, tmp_path)
        ui.outputs = [_output(w)]
        params = dict(edit, input_output_id=0, steps=3)
        try:
            mod._setup_editor_input(ui, params)
            results.append((None, params, ui.server_state["input_latents"],
                            ui.server_state["inpainting_mask"]))
        except ValueError as e:
            results.append((str(e), params, None, None))
    (err, params, lat, mask), (jerr, jparams, jlat, jmask) = results
    assert err == jerr and params == jparams
    if err is None:
        assert lat.dtype == jlat.dtype and np.array_equal(lat, jlat)
        assert (mask is None and jmask is None) or (mask.dtype == jmask.dtype
                                                    and np.array_equal(mask, jmask))
        assert lat.shape == (1, 4, w, 2)


def test_setup_editor_input_without_an_output_id_or_latents(tmp_path):
    """No ``input_output_id`` clears the editor state; an output without
    latents is refused; an unknown id raises IndexError; as in JAX."""
    for mod in (webui, jax_webui):
        ui = mod.UIState({"input_latents": 1, "inpainting_mask": 2}, tmp_path)
        mod._setup_editor_input(ui, {"steps": 2})
        assert ui.server_state == {"input_latents": None, "inpainting_mask": None}
        ui.outputs = [dict(_output(8), latents=None)]
        with pytest.raises(ValueError, match="no latents"):
            mod._setup_editor_input(ui, {"input_output_id": 0, "extend": "append"})
        with pytest.raises(IndexError):
            mod._setup_editor_input(ui, {"input_output_id": 3})


def _images():
    rng = np.random.default_rng(3)
    return [rng.standard_normal((16, 40)), rng.standard_normal((2, 8, 30)),
            rng.standard_normal((1, 1, 12, 10)), np.linspace(0, 1, 77).reshape(7, 11)]


def _port_and_jax_luts(monkeypatch, branch):
    if branch == "cubehelix":
        monkeypatch.setitem(sys.modules, "matplotlib", None)   # the import raises
    lut, jlut = roseus._build_lut(), jax_roseus._build_lut()
    monkeypatch.setattr(roseus, "ROSEUS_LUT", lut)
    monkeypatch.setattr(jax_roseus, "ROSEUS_LUT", jlut)
    return lut, jlut


@pytest.mark.parametrize("branch", ["magma", "cubehelix"])
def test_tensor_to_img_matches_jax(monkeypatch, branch):
    """The colormap LUT and the images of 2-D, 3-D and 4-D inputs (colormap,
    grey, unflipped) equal JAX's on both LUT branches: matplotlib's "magma"
    and, with matplotlib's import blocked, the cubehelix ramp."""
    lut, jlut = _port_and_jax_luts(monkeypatch, branch)
    assert lut.shape == (256, 3) and np.array_equal(lut, jlut)
    if branch == "cubehelix":
        assert np.array_equal(lut, roseus._cubehelix(256))
    for x in _images():
        for kw in ({}, {"colormap": False}, {"flip_y": False}):
            img, jimg = tensor_to_img(x, **kw), jax_utils.tensor_to_img(x, **kw)
            assert img.dtype == np.uint8 and np.array_equal(img, jimg)


def test_png_bytes_decode_to_jax_pixels():
    """The zlib PNG encoder's files decode (PIL) to the pixels of the PNGs
    that JAX ``_png_bytes`` writes through PIL: RGB, 8 bits, every size."""
    for x in _images() + [np.zeros((1, 1)), np.arange(6.0).reshape(1, 6)]:
        img = tensor_to_img(x)
        ours = Image.open(io.BytesIO(webui._png_bytes(img)))
        theirs = Image.open(io.BytesIO(jax_webui._png_bytes(img)))
        assert ours.mode == theirs.mode == "RGB"
        assert np.array_equal(np.asarray(ours), np.asarray(theirs))
        assert np.array_equal(np.asarray(ours), img)
    with pytest.raises(ValueError):
        png_bytes(np.zeros((4, 4), np.uint8))


def test_png_chunks_are_well_formed():
    """Signature, then IHDR (8-bit RGB, no interlace), one IDAT and IEND,
    each with the CRC32 of its type and data."""
    import struct
    import zlib
    data = png_bytes(tensor_to_img(np.eye(5)))
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    off, tags = 8, []
    while off < len(data):
        (n,) = struct.unpack(">I", data[off:off + 4])
        tag, body = data[off + 4:off + 8], data[off + 8:off + 8 + n]
        (crc,) = struct.unpack(">I", data[off + 8 + n:off + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        tags.append((tag, body))
        off += 12 + n
    assert [t for t, _ in tags] == [b"IHDR", b"IDAT", b"IEND"]
    assert struct.unpack(">IIBBBBB", tags[0][1]) == (5, 5, 8, 2, 0, 0, 0)
    rows = np.frombuffer(zlib.decompress(tags[1][1]), np.uint8).reshape(5, 1 + 5 * 3)
    assert np.all(rows[:, 0] == 0)


@pytest.mark.parametrize("scale", [0.3, 2.0])
def test_wav_bytes_match_jax(scale):
    """The WAV bytes of a (C, T) clip, clipped to [-1, 1], byte for byte."""
    audio = scale * np.random.default_rng(4).standard_normal((2, 5000)).astype(np.float32)
    ours = webui._wav_bytes(audio, 32000)
    assert ours == jax_webui._wav_bytes(audio, 32000) and ours[:4] == b"RIFF"


ESC_JAX = """function esc(s){ const d=document.createElement('span');
  d.textContent=String(s); return d.innerHTML; }"""


def _esc_source():
    m = re.search(r"function esc\(s\)\{.*?\}\n", webui._PAGE, re.S)
    assert m
    return m.group(0).rstrip("\n")


def test_page_is_jax_page_but_for_esc():
    """The page equals JAX's once its ``esc()`` is put back: the repair is the
    one difference."""
    esc = _esc_source()
    assert ESC_JAX in jax_webui._PAGE
    assert webui._PAGE.replace(esc, ESC_JAX) == jax_webui._PAGE
    assert webui._PAGE != jax_webui._PAGE


def test_esc_escapes_both_quotes():
    """``esc()`` runs the element's innerHTML (which escapes &, < and >)
    through replacements that map " and ' to entities: applied here to a
    string after innerHTML's own escaping, nothing of either quote is left."""
    esc = _esc_source()
    pairs = re.findall(r"\.replace\(/(.)/g,'([^']*)'\)", esc)
    assert pairs == [('"', "&quot;"), ("'", "&#39;")]
    s = 'a"b\'c&amp;&lt;x&gt;'                 # innerHTML of 'a"b\'c&<x>'
    for ch, ent in pairs:
        s = s.replace(ch, ent)
    assert s == "a&quot;b&#39;c&amp;&lt;x&gt;"
    assert '"' not in s and "'" not in s


def _serve(mod, state, tmp_path):
    ui = mod.UIState(state, tmp_path / "presets")
    ui.outputs = [_output(8, seed=11), _output(8, seed=12)]
    ui.outputs[1]["rating"] = 3
    ui.log_lines = ["12:00:00 hello"]
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), mod._make_handler(ui))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_get_routes_match_jax(tmp_path):
    """Every GET route of both handlers over equal server states (a preview
    in flight, two outputs, a preset, an inventory): the same status codes,
    content types and bodies; PNGs compare by their decoded pixels and the
    page by the test above."""
    (tmp_path / "presets").mkdir()
    (tmp_path / "presets" / "p1.json").write_text(json.dumps({"steps": 7}))
    lat = np.random.default_rng(6).standard_normal((1, 4, 8, 2)).astype(np.float32)
    state = {"prompt_labels": ["a", "b"], "model_modules": ["unet", "dae"],
             "generate_step": 3, "generate_latents": lat, "error": None,
             "inventory": {"unet": {"params": 10}}}
    servers = [_serve(mod, dict(state), tmp_path) for mod in (webui, jax_webui)]
    routes = ["/api/info", "/api/status", "/api/preview.png", "/api/inventory", "/api/outputs",
              "/api/output/0/audio.wav", "/api/output/1/spec.png", "/api/output/5/audio.wav",
              "/api/presets", "/api/presets/p1", "/api/presets/nope", "/api/nope"]
    try:
        for route in routes:
            (code, ctype, body), (jcode, jctype, jbody) = (_get(base + route)
                                                          for _, base in servers)
            assert (code, ctype) == (jcode, jctype), route
            if ctype == "image/png":
                assert np.array_equal(np.asarray(Image.open(io.BytesIO(body))),
                                      np.asarray(Image.open(io.BytesIO(jbody)))), route
            else:
                assert body == jbody, route
        assert _get(servers[0][1] + "/")[2] == webui._PAGE.encode()
    finally:
        for httpd, _ in servers:
            httpd.shutdown()
