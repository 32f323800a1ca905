"""Web UI for interactive generation (JAX: dualdiffusion_tpu/serving/webui.py).

Capability parity with the reference's NiceGUI app
(reference: src/sampling/nicegui_app.py:84-403 + nicegui_elements.py) —
prompt editor with per-label weights, generation parameter editor, preset
system, per-step latent preview with abort, generated-output list with
audio players and spectrogram images, and a debug log tail — rebuilt as a
dependency-free single-page app on ``http.server`` (NiceGUI is not
available in this image). The UI talks to the isolated model-server
process purely through its shared-dict command protocol (the same
process-split architecture as the reference, nicegui_app.py:94-98).

The page is the JAX package's but for ``esc()``, which here escapes double
and single quotes too, since its output lands inside quoted attributes.
Images are PNGs written by ``utils.png_bytes`` (no PIL).
"""

from __future__ import annotations

import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger("webui")

_PAGE = """<!DOCTYPE html>
<html><head><title>dualdiffusion-tpu</title><style>
body{font-family:sans-serif;background:#15171c;color:#dde;margin:0;padding:1.2em;max-width:960px}
h2{color:#8fd} fieldset{border:1px solid #334;margin:.6em 0;border-radius:6px}
input,select{background:#232630;color:#dde;border:1px solid #445;border-radius:4px;padding:3px}
button{background:#2a6;border:0;color:#fff;padding:.45em 1.1em;border-radius:5px;cursor:pointer;margin-right:.5em}
button.warn{background:#a43}
.out{border:1px solid #334;border-radius:6px;padding:.6em;margin:.5em 0}
img.spec{width:100%;image-rendering:pixelated;border-radius:4px}
#log{font-family:monospace;font-size:.8em;white-space:pre-wrap;background:#0c0e12;padding:.5em;max-height:12em;overflow-y:auto}
.lbl{display:inline-block;margin:.2em .6em .2em 0}
progress{width:100%}
</style></head><body>
<h2>dualdiffusion-tpu</h2>
<fieldset><legend>Prompt</legend><div id="labels"></div>
<input id="newlabel" placeholder="label"><input id="newweight" type="number" value="1.0" step="0.1" style="width:5em">
<button onclick="addLabel()">add</button></fieldset>
<fieldset><legend>Parameters</legend>
steps <input id="steps" type="number" value="100" style="width:5em">
cfg <input id="cfg" type="number" value="1.5" step="0.1" style="width:5em">
seed <input id="seed" type="number" value="" placeholder="random" style="width:8em">
fgla iters <input id="fgla" type="number" value="100" style="width:5em">
<label><input id="heun" type="checkbox" checked> heun</label>
<label><input id="loop" type="checkbox"> seamless loop</label>
</fieldset>
<fieldset><legend>Presets</legend>
<select id="presets"></select>
<button onclick="loadPreset()">load</button>
<input id="presetname" placeholder="name"><button onclick="savePreset()">save</button></fieldset>
<fieldset><legend>Model explorer</legend>
<table id="explorer" style="font-size:.85em;border-spacing:.4em 0">
<tr><th align="left">module</th><th align="left">params</th>
<th align="left">checkpoint</th><th align="left">EMA</th></tr></table>
<button onclick="reloadModel()">load selected weights</button></fieldset>
<button onclick="generate()">Generate</button>
<button class="warn" onclick="abortGen()">Abort</button>
<div><progress id="prog" value="0" max="100"></progress><span id="status"></span></div>
<img id="preview" class="spec" style="display:none">
<div id="outputs"></div>
<fieldset><legend>Debug log</legend><div id="log"></div></fieldset>
<script>
// escape server/user-provided strings before interpolating into innerHTML
// (inventory names, labels, presets — ADVICE r4 low: mild stored XSS)
function esc(s){ const d=document.createElement('span');
  d.textContent=String(s);
  return d.innerHTML.replace(/"/g,'&quot;').replace(/'/g,'&#39;'); }
let labels = {};
function renderLabels(){
  const d = document.getElementById('labels'); d.innerHTML='';
  for (const [k,v] of Object.entries(labels)){
    const ke = esc(k), kj = esc(JSON.stringify(k));
    d.innerHTML += `<span class="lbl">${ke}: <input type="number" value="${Number(v)||0}" step="0.1"
      style="width:4.5em" onchange="labels[${kj}]=parseFloat(this.value)">
      <button class="warn" onclick="delete labels[${kj}];renderLabels()">x</button></span>`;
  }
}
function addLabel(){
  const k=document.getElementById('newlabel').value;
  if(k){labels[k]=parseFloat(document.getElementById('newweight').value);renderLabels();}
}
function params(){
  return {steps:+document.getElementById('steps').value,
    cfg_scale:+document.getElementById('cfg').value,
    seed:document.getElementById('seed').value?+document.getElementById('seed').value:null,
    num_fgla_iters:+document.getElementById('fgla').value,
    use_heun:document.getElementById('heun').checked,
    seamless_loop:document.getElementById('loop').checked, prompt:labels};
}
async function generate(extra){
  const p = Object.assign(params(), extra||{});
  await fetch('/api/generate',{method:'POST',body:JSON.stringify(p)});
  poll();
}
async function abortGen(){ await fetch('/api/abort',{method:'POST'}); }
// output editor: regenerate a time range of an output (inpaint) or
// extend it (outpaint) — reference nicegui_elements.py:563-1034
async function inpaintOutput(id){
  const s=+document.getElementById('in_start_'+id).value;
  const e=+document.getElementById('in_end_'+id).value;
  generate({input_output_id:id, inpaint_start:s, inpaint_end:e});
}
async function extendOutput(id){
  const mode=document.getElementById('ext_mode_'+id).value;
  generate({input_output_id:id, extend:mode});
}
async function img2imgOutput(id){
  generate({input_output_id:id,
            img2img_strength:+document.getElementById('i2i_'+id).value});
}
async function poll(){
  const r = await (await fetch('/api/status')).json();
  document.getElementById('status').textContent = r.status;
  document.getElementById('prog').value = r.progress*100;
  if (r.preview){ const p=document.getElementById('preview');
    p.src='/api/preview.png?t='+Date.now(); p.style.display='block'; }
  if (r.busy) setTimeout(poll, 1000);
  else { document.getElementById('preview').style.display='none'; refreshOutputs();
    if (invStale){ invStale=false; refreshInventory(); } }
  document.getElementById('log').textContent = r.log;
}
async function refreshOutputs(){
  const outs = await (await fetch('/api/outputs')).json();
  const d = document.getElementById('outputs'); d.innerHTML='';
  outs.forEach(o=>{ d.innerHTML += `<div class="out">seed ${o.seed}
    <audio id="au_${o.id}" controls src="/api/output/${o.id}/audio.wav"
      style="width:100%"></audio>
    <div class="specscroll" id="sc_${o.id}" style="overflow-x:auto">
    <div class="specwrap" id="wr_${o.id}" style="position:relative;width:100%">
      <img class="spec" id="sp_${o.id}" src="/api/output/${o.id}/spec.png"
        draggable="false" style="display:block;width:100%">
      <div id="sel_${o.id}" style="position:absolute;top:0;bottom:0;
        background:rgba(140,220,255,.25);border:1px solid #8fd;
        display:none;pointer-events:none"></div>
      <div id="ph_${o.id}" style="position:absolute;top:0;bottom:0;left:0;
        width:2px;background:#8fd;pointer-events:none"></div></div></div>
    <div>inpaint <input id="in_start_${o.id}" type="number" value="0"
      style="width:4.5em"> - <input id="in_end_${o.id}" type="number"
      value="10" style="width:4.5em"> s
      <button onclick="inpaintOutput(${o.id})">inpaint</button>
      <select id="ext_mode_${o.id}"><option>append</option>
        <option>prepend</option></select>
      <button onclick="extendOutput(${o.id})">extend</button>
      img2img <input id="i2i_${o.id}" type="number" value="0.5" step="0.05"
        style="width:4.5em">
      <button onclick="img2imgOutput(${o.id})">remix</button>
      rating <span id="rt_${o.id}">${stars(o.id, o.rating)}</span>
      <button onclick="saveOutput(${o.id})">save</button></div></div>`; });
  outs.forEach(o=>{ const a=document.getElementById('au_'+o.id);
    a.ontimeupdate = ()=>{ const img=document.getElementById('sp_'+o.id);
      const ph=document.getElementById('ph_'+o.id);
      if (a.duration) ph.style.left=(a.currentTime/a.duration*img.clientWidth)+'px'; };
    setupEditor(o.id);
  });
}
function stars(id, r){
  let h='';
  for (let i=1;i<=5;i++)
    h += `<span style="cursor:pointer;color:${(r||0)>=i?'#fd5':'#556'}`
      + `" onclick="rateOutput(${id},${i})">★</span>`;
  return h;
}
async function rateOutput(id, r){
  await fetch('/api/output/'+id+'/rate',{method:'POST',
    body:JSON.stringify({rating:r})});
  refreshOutputs();
}
async function saveOutput(id){
  const r = await (await fetch('/api/output/'+id+'/save',
    {method:'POST',body:'{}'})).json();
  alert(r.path ? 'saved '+r.path : (r.error||'save failed'));
}
// waveform editor: drag on the spectrogram selects the inpaint region
// (filling the numeric start/end boxes), click (no drag) seeks+plays,
// double-click clears the selection, mouse wheel zooms the view around
// the cursor (reference: nicegui_audio_editor.js region select/zoom/drag
// + nicegui_custom_audio.js seek-on-click)
function setupEditor(id){
  const wrap=document.getElementById('wr_'+id);
  const scroll=document.getElementById('sc_'+id);
  const img=document.getElementById('sp_'+id);
  const sel=document.getElementById('sel_'+id);
  const a=document.getElementById('au_'+id);
  let drag=null, zoom=1;
  const frac=ev=>{
    const r=img.getBoundingClientRect();
    return Math.min(Math.max((ev.clientX-r.left)/r.width,0),1);
  };
  wrap.onmousedown=ev=>{ drag={x0:frac(ev), moved:false}; ev.preventDefault(); };
  wrap.onmousemove=ev=>{
    if(!drag) return;
    const x1=frac(ev);
    if (Math.abs(x1-drag.x0)*img.clientWidth>3) drag.moved=true;
    if (drag.moved){
      const lo=Math.min(drag.x0,x1), hi=Math.max(drag.x0,x1);
      sel.style.display='block';
      sel.style.left=(lo*100)+'%'; sel.style.width=((hi-lo)*100)+'%';
      if (a.duration){
        document.getElementById('in_start_'+id).value=(lo*a.duration).toFixed(2);
        document.getElementById('in_end_'+id).value=(hi*a.duration).toFixed(2);
      }
    }
  };
  wrap.onmouseup=ev=>{
    if (drag && !drag.moved && a.duration){
      a.currentTime=frac(ev)*a.duration; a.play();
    }
    drag=null;
  };
  wrap.onmouseleave=()=>{ drag=null; };
  wrap.ondblclick=()=>{ sel.style.display='none'; };
  wrap.onwheel=ev=>{
    ev.preventDefault();
    const f=frac(ev);
    zoom=Math.min(Math.max(zoom*(ev.deltaY<0?1.25:0.8),1),16);
    wrap.style.width=(zoom*100)+'%';
    scroll.scrollLeft=f*img.clientWidth - ev.clientX
      + scroll.getBoundingClientRect().left;
  };
}
// model explorer: per-module checkpoint + EMA pickers
// (reference: nicegui_app.py:84-221 model explorer tab)
let invModules = [], invStale = false;
function fmtParams(n){
  return n>=1e6 ? (n/1e6).toFixed(1)+'M' : n>=1e3 ? (n/1e3).toFixed(1)+'k' : n;
}
async function refreshInventory(){
  const r = await (await fetch('/api/inventory')).json();
  if (r.pending){ setTimeout(refreshInventory, 1000); return; }
  invModules = Object.keys(r);
  const t = document.getElementById('explorer');
  while (t.rows.length > 1) t.deleteRow(1);
  for (const [m, v] of Object.entries(r)){
    const opt=(val,cur)=>`<option${val===cur?' selected':''}>${esc(val)}</option>`;
    const cks=['root','latest'].concat(v.checkpoints||[])
      .map(c=>opt(c, v.loaded_checkpoint)).join('');
    const emas=['none'].concat(v.emas||[])
      .map(e=>opt(e, v.loaded_ema)).join('');
    t.insertRow().innerHTML = `<td>${esc(m)} <span style="color:#789">(${esc(v.type||'')})</span></td>
      <td>${fmtParams(v.params||0)}</td>
      <td><select id="ck_${esc(m)}">${cks}</select></td>
      <td><select id="ema_${esc(m)}">${emas}</select></td>`;
  }
}
async function reloadModel(){
  const cks = {}, emas = {};
  for (const m of invModules){
    const c = document.getElementById('ck_'+m);
    if (c && c.value !== 'root') cks[m] = c.value;
    const e = document.getElementById('ema_'+m);
    if (e && e.value !== 'none') emas[m] = e.value;
  }
  const r = await (await fetch('/api/load_model',{method:'POST',
    body:JSON.stringify({load_checkpoints:cks, load_emas:emas})})).json();
  document.getElementById('status').textContent = r.error||'model reloading...';
  invStale = true;
  poll();
}
async function refreshPresets(){
  const ps = await (await fetch('/api/presets')).json();
  const s = document.getElementById('presets'); s.innerHTML='';
  ps.forEach(p=>{ s.innerHTML += `<option>${esc(p)}</option>`; });
}
async function loadPreset(){
  const name = document.getElementById('presets').value;
  const p = await (await fetch('/api/presets/'+name)).json();
  labels = p.prompt||{}; renderLabels();
  for (const k of ['steps','fgla']) if(p[k]!==undefined) document.getElementById(k).value=p[k];
  if(p.cfg_scale!==undefined) document.getElementById('cfg').value=p.cfg_scale;
}
async function savePreset(){
  const name = document.getElementById('presetname').value||'preset';
  await fetch('/api/presets/'+name,{method:'POST',body:JSON.stringify(params())});
  refreshPresets();
}
(async ()=>{
  const info = await (await fetch('/api/info')).json();
  (info.prompt_labels||[]).slice(0,0).forEach(l=>{});
  refreshPresets(); refreshOutputs(); refreshInventory(); poll();
})();
</script></body></html>
"""


class UIState:
    def __init__(self, server_state, presets_path: Path) -> None:
        self.server_state = server_state
        self.outputs: List[Dict[str, Any]] = []
        self.presets_path = presets_path
        self.log_lines: List[str] = []
        self.busy = False
        self.total_steps = 1

    def log(self, msg: str) -> None:
        self.log_lines.append(f"{time.strftime('%H:%M:%S')} {msg}")
        self.log_lines = self.log_lines[-200:]


def _make_handler(ui: UIState):
    from ..utils import tensor_to_img

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, body: bytes, ctype: str = "application/json",
                  code: int = 200) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200) -> None:
            self._send(json.dumps(obj).encode(), code=code)

        def do_GET(self):
            s = ui.server_state
            if self.path == "/":
                self._send(_PAGE.encode(), "text/html")
            elif self.path == "/api/info":
                self._json({"prompt_labels": s.get("prompt_labels", []),
                            "modules": s.get("model_modules", [])})
            elif self.path == "/api/status":
                step = s.get("generate_step")
                generating = ui.busy and step is not None
                progress = (step or 0) / max(ui.total_steps, 1)
                if generating:
                    status = f"step {step}/{ui.total_steps}"
                elif ui.busy:
                    status = "working..."
                else:
                    status = s.get("error") or "idle"
                self._json({"busy": ui.busy, "progress": progress,
                            "status": status,
                            "preview": s.get("generate_latents") is not None,
                            "log": "\n".join(ui.log_lines[-40:])})
            elif self.path.startswith("/api/preview.png"):
                lat = s.get("generate_latents")
                if lat is None:
                    self._json({"error": "no preview"}, 404)
                    return
                img = tensor_to_img(np.asarray(lat)[0].mean(axis=-1))
                self._send(_png_bytes(img), "image/png")
            elif self.path == "/api/inventory":
                # non-blocking: kick the command once and let the client
                # re-poll (a ThreadingHTTPServer thread must never sleep
                # on the accelerator process)
                inv = s.get("inventory")
                if inv is None:
                    if s.get("cmd") is None:
                        s["cmd"] = "get_inventory"
                    self._json({"pending": True})
                else:
                    self._json(dict(inv))
            elif self.path == "/api/outputs":
                self._json([{"id": i, "seed": o["seed"],
                             "rating": o.get("rating")}
                            for i, o in enumerate(ui.outputs)])
            elif self.path.startswith("/api/output/"):
                parts = self.path.strip("/").split("/")
                idx = int(parts[2])
                if idx >= len(ui.outputs):
                    self._json({"error": "bad index"}, 404)
                    return
                o = ui.outputs[idx]
                if parts[3].startswith("audio"):
                    self._send(_wav_bytes(o["raw"][0], o["sample_rate"]),
                               "audio/wav")
                else:
                    img = tensor_to_img(np.asarray(o["sample"])[0, :, :, 0])
                    self._send(_png_bytes(img), "image/png")
            elif self.path == "/api/presets":
                self._json(sorted(p.stem for p in
                                  ui.presets_path.glob("*.json")))
            elif self.path.startswith("/api/presets/"):
                name = self.path.rsplit("/", 1)[1]
                p = ui.presets_path / f"{name}.json"
                if p.is_file():
                    self._send(p.read_bytes())
                else:
                    self._json({"error": "unknown preset"}, 404)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            # (model reload with checkpoint/EMA selection handled below)
            body = self.rfile.read(length).decode() if length else "{}"
            s = ui.server_state
            if self.path == "/api/generate":
                if ui.busy:
                    self._json({"error": "busy"}, 409)
                    return
                sample_params = json.loads(body)
                try:
                    _setup_editor_input(ui, sample_params)
                except (KeyError, IndexError, ValueError) as e:
                    self._json({"error": f"bad editor input: {e}"}, 400)
                    return
                ui.total_steps = int(sample_params.get("steps", 100))
                s["sample_params"] = sample_params
                s["cmd"] = "generate"
                ui.busy = True
                ui.log(f"generate: { {k: v for k, v in sample_params.items()} }")
                threading.Thread(target=_wait_generate, args=(ui,),
                                 daemon=True).start()
                self._json({"ok": True})
            elif self.path == "/api/abort":
                s["generate_abort"] = True
                ui.log("abort requested")
                self._json({"ok": True})
            elif self.path == "/api/load_model":
                # model settings: reload with checkpoint / per-module EMA
                # selection (the reference UI's Model Settings tab).
                # Non-blocking: a waiter thread tracks completion; the
                # client polls /api/status.
                if ui.busy:
                    self._json({"error": "busy"}, 409)
                    return
                opts = json.loads(body)
                ck = opts.get("load_checkpoints", False)
                s["model_load_options"] = {
                    # bool (all-latest) or per-module dict from the model
                    # explorer ({module: "latest"|"<ckpt dir>"|step})
                    "load_checkpoints": ck if isinstance(ck, dict) else bool(ck),
                    "load_emas": opts.get("load_emas") or {},
                }
                s["inventory"] = None  # refresh after reload
                s["cmd"] = "load_model"
                ui.busy = True

                def wait_load():
                    while s.get("cmd") is not None:
                        time.sleep(0.25)
                    err = s.get("error")
                    ui.log(f"model reloaded ({opts})" if not err else err)
                    ui.busy = False

                threading.Thread(target=wait_load, daemon=True).start()
                self._json({"ok": True})
            elif self.path.startswith("/api/presets/"):
                name = self.path.rsplit("/", 1)[1]
                ui.presets_path.mkdir(parents=True, exist_ok=True)
                (ui.presets_path / f"{name}.json").write_text(body)
                ui.log(f"saved preset '{name}'")
                self._json({"ok": True})
            elif self.path.startswith("/api/output/"):
                # rating + save-to-disk workflow (the reference app rates
                # outputs and writes the rating into the audio file's
                # tags, nicegui_elements.py rating controls +
                # dual_diffusion_utils.update_audio_metadata)
                parts = self.path.strip("/").split("/")
                if len(parts) < 4:     # /api/output/<idx>/<action>
                    self._json({"error": "bad path"}, 404)
                    return
                try:
                    o = ui.outputs[int(parts[2])]
                except (IndexError, ValueError):
                    self._json({"error": "bad index"}, 404)
                    return
                if parts[3] == "rate":
                    o["rating"] = int(json.loads(body).get("rating", 0))
                    if o.get("saved_path"):
                        _tag_saved_output(o)
                    self._json({"ok": True, "rating": o["rating"]})
                elif parts[3] == "save":
                    try:
                        path = _save_output(ui, o)
                        ui.log(f"saved {path}")
                        self._json({"ok": True, "path": str(path)})
                    except OSError as e:
                        self._json({"error": str(e)}, 500)
                else:
                    self._json({"error": "not found"}, 404)
            else:
                self._json({"error": "not found"}, 404)

    return Handler


def _setup_editor_input(ui: UIState, sample_params: Dict[str, Any]) -> None:
    """Translate output-editor requests (inpaint range / extend / img2img
    remix of a previous output) into the model server's
    input_latents/inpainting_mask state (reference flow:
    nicegui_elements.py:693-716)."""
    s = ui.server_state
    out_id = sample_params.pop("input_output_id", None)
    inpaint_start = sample_params.pop("inpaint_start", None)
    inpaint_end = sample_params.pop("inpaint_end", None)
    extend = sample_params.pop("extend", None)
    if out_id is None:
        s["input_latents"] = None
        s["inpainting_mask"] = None
        return
    o = ui.outputs[int(out_id)]
    if o.get("latents") is None:
        raise ValueError("output has no latents to edit")
    lat = np.asarray(o["latents"])[0:1]          # (1, H, W, C)
    w = lat.shape[2]
    duration_s = o["raw"].shape[-1] / o["sample_rate"]
    cols_per_s = w / max(duration_s, 1e-6)
    mask = None
    if extend in ("append", "prepend"):
        # outpaint: shift the clip by half its length and regenerate the
        # freed half as a continuation (reference :704-716)
        half = w // 2          # freed (regenerated) width; kept = w - half
        keep = w - half
        mask = np.zeros((1, 1, w, 1), np.float32)
        if extend == "append":
            lat = np.concatenate([lat[:, :, w - keep:],
                                  np.zeros_like(lat[:, :, :half])], axis=2)
            mask[:, :, keep:] = 1.0
        else:
            lat = np.concatenate([np.zeros_like(lat[:, :, :half]),
                                  lat[:, :, :keep]], axis=2)
            mask[:, :, :half] = 1.0
    elif inpaint_start is not None and inpaint_end is not None:
        c0 = max(int(float(inpaint_start) * cols_per_s), 0)
        c1 = min(int(float(inpaint_end) * cols_per_s), w)
        if c1 <= c0:
            raise ValueError("empty inpaint range")
        mask = np.zeros((1, 1, w, 1), np.float32)
        mask[:, :, c0:c1] = 1.0
    # else: plain img2img remix (strength already in sample_params)
    s["input_latents"] = lat
    s["inpainting_mask"] = mask


def _wait_generate(ui: UIState) -> None:
    s = ui.server_state
    while s.get("cmd") is not None:
        time.sleep(0.25)
    out = s.get("generate_output")
    err = s.get("error")
    s["input_latents"] = None
    s["inpainting_mask"] = None
    if err:
        ui.log(err)
    if out is not None:
        ui.outputs.insert(0, out)
        ui.log(f"generated output (seed {out['seed']})")
    ui.busy = False


def _save_output(ui: UIState, o: Dict[str, Any]) -> Path:
    """Write an output to <model>/output/ and tag it with its rating +
    generation metadata (reference: nicegui_app.py save flow into the
    model's output dir with mutagen tags)."""
    from ..utils import save_audio
    out_dir = ui.presets_path.parent / "output"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"output_{time.strftime('%Y%m%d_%H%M%S')}_{o['seed']}.wav"
    save_audio(np.asarray(o["raw"][0]), o["sample_rate"], path)
    o["saved_path"] = str(path)
    _tag_saved_output(o)
    return path


def _tag_saved_output(o: Dict[str, Any]) -> None:
    from ..utils import update_audio_metadata
    meta = {"seed": o["seed"]}
    if o.get("prompt"):
        meta["prompt"] = json.dumps(o["prompt"])
    update_audio_metadata(o["saved_path"], metadata=meta,
                          rating=o.get("rating"))


def _wav_bytes(audio: np.ndarray, sample_rate: int) -> bytes:
    from scipy.io import wavfile
    buf = io.BytesIO()
    pcm = (np.clip(np.asarray(audio).T, -1, 1) * 32767).astype(np.int16)
    wavfile.write(buf, sample_rate, pcm)
    return buf.getvalue()


def _png_bytes(img: np.ndarray) -> bytes:
    from ..utils import png_bytes
    return png_bytes(img)


def run_app(model_path: str, host: str = "127.0.0.1", port: int = 8080,
            state=None, device="cuda") -> None:
    """Launch the model-server process on ``device`` + the web UI
    (blocking). Raises if the model does not load."""
    from .model_server import launch
    if state is None:
        proc, state = launch(model_path, device=device)
    ui = UIState(state, Path(model_path) / "presets")
    # wait for model load
    t0 = time.time()
    while state.get("cmd") is not None and time.time() - t0 < 600:
        time.sleep(0.25)
    if state.get("error"):
        # no model to serve (a missing directory, or no card for "cuda"):
        # stop the server process rather than serve a UI that cannot generate
        state["cmd"] = "shutdown"
        raise RuntimeError(f"model load failed: {state['error']}")
    httpd = ThreadingHTTPServer((host, port), _make_handler(ui))
    logger.info("web ui at http://%s:%d", host, port)
    print(f"web ui at http://{host}:{port}", flush=True)
    httpd.serve_forever()
