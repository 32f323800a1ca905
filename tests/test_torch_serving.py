"""The port's serving entry points on the CPU: a real model-server process
(``launch(..., device="cpu")``, spawned) behind the port's web UI handlers on
a port-0 HTTP server, driven as tests/test_serving.py drives the JAX one
(generate and the outputs' WAV and PNG, the non-blocking inventory, the
output editor's inpaint and extend, the module state dict and the latent
shape, rating and saving, the model explorer's checkpoint/EMA reload), plus:
the server's output equals an in-process ``Pipeline.generate`` with the same
seed, exactly; an abort mid-run, or after the last step, and a request
that fails leave no output; a JAX-written model
directory served by the port reports the JAX parameter counts and the JAX
flat weights; and ``device="cuda"`` without a card ends in an error, never in
CPU output.

The tiny model is tests/test_pipeline.py's ``make_pipeline``, written by the
JAX package and re-saved by the port.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.pipelines.pipeline import Pipeline as JaxPipeline, _flatten
from dualdiffusion_tpu_torch.pipelines.pipeline import Pipeline, save_module
from dualdiffusion_tpu_torch.sampling import SampleParams
from dualdiffusion_tpu_torch.serving import launch, run_app
from dualdiffusion_tpu_torch.serving.webui import UIState, _make_handler
from dualdiffusion_tpu_torch.utils import get_audio_metadata, save_safetensors
from dualdiffusion_tpu_torch.weights import to_flat
from test_pipeline import make_pipeline

SMALL = {"steps": 2, "use_heun": False, "cfg_scale": 1.0, "length": 4096, "num_fgla_iters": 2}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _http(url, body=None, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode() if body is not None else None,
        method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        data = r.read()
        ctype = r.headers.get("Content-Type", "")
    return json.loads(data) if ctype.startswith("application/json") else data


def _wait_cmd(state, timeout=120):
    t0 = time.time()
    while state.get("cmd") is not None:
        if time.time() - t0 > timeout:
            raise TimeoutError(f"command {state.get('cmd')!r} did not finish")
        time.sleep(0.05)


def _command(state, cmd, timeout=120, **kw):
    for k, v in kw.items():
        state[k] = v
    state["cmd"] = cmd
    _wait_cmd(state, timeout)
    assert state.get("error") is None, state.get("error")


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving")
    make_pipeline(jax.random.PRNGKey(0)).save_pretrained(root / "jax_model")
    model_dir = root / "model"
    Pipeline.from_pretrained(root / "jax_model", device="cpu").save_pretrained(model_dir)

    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")          # the spawned server computes on one thread
    proc, state = launch(str(model_dir), device="cpu")
    _wait_cmd(state)
    assert state.get("error") is None, state.get("error")

    ui = UIState(state, model_dir / "presets")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(ui))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", state, ui, root
    state["cmd"] = "shutdown"
    httpd.shutdown()
    proc.join(timeout=20)
    if proc.is_alive():
        proc.terminate()
    mp.undo()


def _generate(base, body, timeout=120):
    r = _http(f"{base}/api/generate", body)
    assert r.get("ok"), r
    t0 = time.time()
    while time.time() - t0 < timeout:
        if not _http(f"{base}/api/status")["busy"]:
            break
        time.sleep(0.1)
    else:
        raise TimeoutError("generate did not finish")
    return _http(f"{base}/api/outputs")


def test_serving_generate_and_outputs(serving):
    base, state, ui, _ = serving
    assert b"dualdiffusion-tpu" in _http(f"{base}/")
    info = _http(f"{base}/api/info")
    assert "unet" in info["modules"] and info["prompt_labels"] == ["gameA"]
    _command(state, "get_available_devices")
    assert state["available_devices"] == ["cpu"]

    n0 = len(ui.outputs)
    outs = _generate(base, dict(SMALL))
    assert len(outs) == n0 + 1
    o = ui.outputs[0]
    assert all(isinstance(o[k], np.ndarray) for k in ("raw", "sample", "latents"))
    assert o["raw"].shape[:2] == (1, 2) and np.isfinite(o["raw"]).all()
    assert o["latents"].ndim == 4 and o["sample_rate"] == 32000
    wav = _http(f"{base}/api/output/0/audio.wav")
    assert wav[:4] == b"RIFF"
    png = _http(f"{base}/api/output/0/spec.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"


def test_serving_inventory_nonblocking(serving):
    base, state, ui, _ = serving
    state["inventory"] = None
    t0 = time.time()
    r = _http(f"{base}/api/inventory")
    assert time.time() - t0 < 2.0
    for _ in range(100):
        if not (isinstance(r, dict) and r.get("pending")):
            break
        time.sleep(0.1)
        r = _http(f"{base}/api/inventory")
    assert "unet" in r and r["unet"]["params"] > 0


def test_serving_output_editor_inpaint_and_extend(serving):
    base, state, ui, _ = serving
    if not ui.outputs:
        _generate(base, dict(SMALL))
    n0 = len(ui.outputs)
    outs = _generate(base, dict(SMALL, input_output_id=0, inpaint_start=0.0,
                                inpaint_end=0.05))
    assert len(outs) == n0 + 1
    assert state.get("input_latents") is None
    outs = _generate(base, dict(SMALL, input_output_id=0, extend="append"))
    assert len(outs) == n0 + 2
    for o in ui.outputs:
        assert np.isfinite(np.asarray(o["raw"])).all()


def test_serving_module_state_dict_and_latent_shape(serving):
    base, state, ui, _ = serving
    _command(state, "get_module_state_dict", module_name="unet")
    sd = state.get("module_state_dict")
    assert sd and all(isinstance(v, np.ndarray) for v in sd.values())
    _command(state, "get_latent_shape", audio_length=4096)
    shape = state.get("latent_shape")
    assert isinstance(shape, tuple) and len(shape) == 4
    if ui.outputs:
        assert shape == tuple(ui.outputs[-1]["latents"].shape)


def test_serving_rate_and_save_output(serving):
    base, state, ui, _ = serving
    if not ui.outputs:
        _generate(base, dict(SMALL))
    r = _http(f"{base}/api/output/0/rate", {"rating": 4})
    assert r["ok"] and r["rating"] == 4
    assert _http(f"{base}/api/outputs")[0]["rating"] == 4
    r = _http(f"{base}/api/output/0/save", {})
    assert r.get("ok"), r
    assert get_audio_metadata(r["path"])["RATING"] == ["4"]
    assert Path(r["path"]).is_file()
    _http(f"{base}/api/output/0/rate", {"rating": 1})
    assert get_audio_metadata(r["path"])["RATING"] == ["1"]
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(urllib.request.Request(f"{base}/api/output/99/rate", data=b"{}",
                                                      method="POST"), timeout=10)
    assert e.value.code == 404


def test_serving_model_explorer_checkpoint_ema_load(serving):
    """A checkpoint with an EMA, made in the live model directory, is listed
    by the inventory and loaded through /api/load_model; the served weights
    are then the EMA file's."""
    base, state, ui, _ = serving
    model_dir = Path(state["model_name"])
    pipe = Pipeline.from_pretrained(model_dir, device="cpu")
    h = pipe.modules["unet"]
    flat = to_flat(h.module)
    ckpt = model_dir / "unet_checkpoint-10"
    with torch.no_grad():
        for p in h.module.parameters():
            p.mul_(2.0)
    save_module(ckpt, "unet", h.module_type, h.config, h.module, 10)
    save_safetensors({k: v * 0.25 for k, v in flat.items()},
                     ckpt / "unet" / "ema_explorer.safetensors")

    state["inventory"] = None
    r = _http(f"{base}/api/load_model", {"load_checkpoints": {"unet": "unet_checkpoint-10"},
                                         "load_emas": {"unet": "explorer"}})
    assert r.get("ok"), r
    t0 = time.time()
    while _http(f"{base}/api/status")["busy"] and time.time() - t0 < 120:
        time.sleep(0.1)
    assert state.get("error") is None, state.get("error")
    for _ in range(100):
        inv = _http(f"{base}/api/inventory")
        if not (isinstance(inv, dict) and inv.get("pending")):
            break
        time.sleep(0.1)
    assert "unet_checkpoint-10" in inv["unet"]["checkpoints"]
    assert inv["unet"]["loaded_checkpoint"] == "unet_checkpoint-10"
    assert inv["unet"]["loaded_ema"] == "explorer"
    assert inv["unet"]["params"] > 0 and inv["unet"]["type"] == "unet"

    _command(state, "get_module_state_dict", module_name="unet")
    sd = state["module_state_dict"]
    assert sorted(sd) == sorted(flat)
    for k in flat:
        np.testing.assert_allclose(sd[k], flat[k] * 0.25, rtol=1e-6)
    _command(state, "load_model", model_load_options={})


def test_server_output_equals_in_process_generate(serving):
    """With a seed, the server's ``generate_output`` (raw, mel, latents) is
    an in-process ``Pipeline.generate`` with ``torch.Generator().manual_seed``
    of that seed and the server's chunking, exactly: the server adds
    nothing."""
    base, state, ui, _ = serving
    body = dict(SMALL, steps=4, use_heun=True, cfg_scale=1.5, seed=1234,
                prompt={"gameA": 1.0})
    _generate(base, body)
    out = state["generate_output"]
    assert out["seed"] == 1234 and out["sample_rate"] == 32000
    pipe = Pipeline.from_pretrained(state["model_name"], device="cpu")
    params = SampleParams(**{k: v for k, v in body.items()})
    seen = []
    want = pipe.generate(params, torch.Generator().manual_seed(1234),
                         prompt_embedding=pipe.get_prompt_embedding(params.prompt),
                         chunk_size=1, chunk_callback=lambda d, s: seen.append(d) and False)
    assert seen == [1, 2, 3, 4]
    for k in ("raw", "sample", "latents"):
        assert out[k].dtype == np.float32
        np.testing.assert_array_equal(out[k], want[k].float().numpy(), err_msg=k)
    assert np.array_equal(ui.outputs[0]["raw"], out["raw"])


def test_abort_mid_run_leaves_no_output(serving):
    """/api/abort after the first preview ends the request at the next chunk:
    ``generate_output`` None, no output added, no error, the server idle."""
    base, state, ui, _ = serving
    n0 = len(ui.outputs)
    r = _http(f"{base}/api/generate", dict(SMALL, steps=2000))
    assert r.get("ok"), r
    t0 = time.time()
    while not _http(f"{base}/api/status")["preview"]:
        assert time.time() - t0 < 60
        time.sleep(0.02)
    assert _http(f"{base}/api/preview.png")[:8] == b"\x89PNG\r\n\x1a\n"
    step = state["generate_step"]
    _http(f"{base}/api/abort", {})
    while _http(f"{base}/api/status")["busy"]:
        assert time.time() - t0 < 120
        time.sleep(0.05)
    assert state["generate_output"] is None and state.get("error") is None
    assert len(ui.outputs) == n0
    assert state["generate_step"] is None and state["generate_latents"] is None
    assert 0 < step < 2000
    st = _http(f"{base}/api/status")
    assert st["status"] == "idle" and not st["preview"]


def test_failed_request_adds_no_output(serving):
    """A request that fails in the server (an editor request on latents of the
    wrong channel count) leaves ``generate_output`` at None, so the UI adds
    nothing, not even the previous request's clip, and shows the error."""
    base, state, ui, _ = serving
    _generate(base, dict(SMALL))
    assert state["generate_output"] is not None
    bad = dict(ui.outputs[0])
    bad["latents"] = np.concatenate([bad["latents"], bad["latents"][..., :1]], axis=-1)
    ui.outputs.insert(0, bad)
    n0 = len(ui.outputs)
    _generate(base, dict(SMALL, input_output_id=0, inpaint_start=0.0, inpaint_end=0.05))
    assert state.get("error") and state["generate_output"] is None
    assert len(ui.outputs) == n0
    assert _http(f"{base}/api/status")["status"] == state["error"]
    ui.outputs.pop(0)
    _generate(base, dict(SMALL))
    assert state.get("error") is None and len(ui.outputs) == n0


def test_abort_after_the_last_step_drops_the_output(serving):
    """An abort that arrives after the last preview, while the clip decodes,
    drops the clip (JAX model_server.py:116): ``generate_output`` is None.
    Driven on an in-process server over a plain dict, with the abort set as
    ``Pipeline.generate`` returns."""
    from dualdiffusion_tpu_torch.serving import ModelServer
    state = {"model_name": str(serving[3] / "model"), "sample_params": dict(SMALL, steps=2)}
    server = ModelServer(state, "cpu")
    server.cmd_load_model()
    generate = server.pipeline.generate
    seen = []

    def generate_then_abort(*args, **kw):
        out = generate(*args, **kw)
        seen.append(state["generate_step"])     # the last preview was taken
        state["generate_abort"] = True
        return out

    server.cmd_generate()
    assert state["generate_output"]["raw"].shape[:2] == (1, 2)
    server.pipeline.generate = generate_then_abort
    server.cmd_generate()
    assert seen == [2] and state["generate_output"] is None
    assert state["generate_step"] is None and state["generate_latents"] is None


def test_jax_written_model_served_by_the_port(serving):
    """The JAX-written directory loads in the server: the inventory reports
    the JAX variables' leaf counts and ``get_module_state_dict`` the JAX
    ``_flatten`` keys and values."""
    base, state, ui, root = serving
    jax_dir = root / "jax_model"
    jpipe = JaxPipeline.from_pretrained(jax_dir)
    try:
        _command(state, "load_model", model_name=str(jax_dir), model_load_options={})
        _command(state, "get_inventory")
        inv = state["inventory"]
        for name, h in jpipe.modules.items():
            want = (0 if h.variables is None else
                    sum(int(np.size(x)) for x in jax.tree_util.tree_leaves(h.variables)))
            assert inv[name]["params"] == want, name
        for name in ("unet", "dae"):
            _command(state, "get_module_state_dict", module_name=name)
            sd = state["module_state_dict"]
            want = _flatten(jpipe.modules[name].variables)
            assert sorted(sd) == sorted(want), name
            assert any(k.endswith("#0d") for k in want)
            for k, v in want.items():
                assert sd[k].shape == v.shape and np.array_equal(sd[k], v), k
    finally:
        _command(state, "load_model", model_name=str(root / "model"), model_load_options={})


def test_cuda_without_a_card_is_an_error(serving, monkeypatch):
    """``launch(device="cuda")`` with no card: ``load_model`` writes its error
    to the dict, a generate after it writes another and no output, and the
    server lists no device; ``run_app`` raises instead of serving."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    model_dir = serving[3] / "model"
    proc, state = launch(str(model_dir), device="cuda")
    try:
        _wait_cmd(state)
        assert "CUDA" in (state.get("error") or "")
        state["sample_params"] = dict(SMALL)
        state["cmd"] = "generate"
        _wait_cmd(state)
        assert state.get("error") and state.get("generate_output") is None
        state["cmd"] = "get_available_devices"
        _wait_cmd(state)
        assert state["available_devices"] == []
    finally:
        state["cmd"] = "shutdown"
        proc.join(timeout=20)
        if proc.is_alive():
            proc.terminate()
    with pytest.raises(RuntimeError, match="model load failed.*CUDA"):
        run_app(str(model_dir), port=0, device="cuda")
