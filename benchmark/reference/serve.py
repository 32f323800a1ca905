"""The plain reference of a served request, and the comparison that
decides ``correct`` for the generate cells.

A request is: the latent sampler (the latent UNet under CFG, Heun), the DAE
decode, then the audio decode: Griffin-Lim from the mel, or the DDEC
sampler conditioned on the mel's linear PSD and the inverse MDCT. The
reference follows the port stage by stage: it samples the latents from the
request's noise and embedding, and decodes the mel from the port's latents
and the audio from the port's mel. Each stage's gap is the relative L2
distance of the port's output from the reference's, taken over the gap
that the stated precision (bfloat16) makes on its own, except Griffin-Lim's:
the gap of its spectral convergence (``compare``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import audio, model
from .precision import Precision, REFERENCE, STATED, no_tf32
from .sampler import edm_sample, skip_draws


def first_row(rows):
    """The first of ``rows`` (a slice or a list), as a slice of one."""
    i = rows[0] if isinstance(rows, list) else (rows.start or 0)
    return slice(i, i + 1)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double().to(got.device)
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


class ServeReference:
    """The request's math in plain PyTorch at a ``Precision``, from the
    benchmark's configuration file and the same name-keyed weights the port
    was given."""

    def __init__(self, config: dict, weights: Dict[str, Dict[str, torch.Tensor]], device,
                 prec: Precision = REFERENCE):
        self.config, self.prec, self.device = config, prec, torch.device(device)
        self.unet = model.load(model.UNet(config["unet"]), weights["unet"]).to(self.device)
        self.dae = model.load(model.DAE(config["dae"]), weights["dae"]).to(self.device)
        self.ddec = (model.load(model.UNet(config["ddec"]), weights["ddec"]).to(self.device)
                     if "ddec" in config else None)
        fmt = config["format"]
        self.decoder = (audio.SpectrogramDecode(fmt) if fmt["type"] == "spectrogram"
                        else audio.MDCTDualDecode(fmt))

    @torch.no_grad()
    def latents(self, traffic: dict, shape: tuple, seed: int, emb: torch.Tensor,
                rows: slice, prec: Optional[Precision] = None) -> torch.Tensor:
        ucfg = self.unet.cfg
        prec = prec or self.prec
        gen = torch.Generator(device=self.device).manual_seed(seed)
        e = emb[rows].to(self.device)
        b = e.shape[0]
        labels = torch.cat([self.unet.label_embeddings(e, torch.ones(b, device=self.device),
                                                       prec),
                            self.unet.label_embeddings(e, torch.zeros(b, device=self.device),
                                                       prec)])
        with no_tf32():
            return edm_sample(lambda x, s: self.unet(x, s, labels, prec), shape,
                              traffic["steps"], ucfg["sigma_max"], ucfg["sigma_min"],
                              ucfg["sigma_data"], traffic["cfg_scale"], gen, rows)

    @torch.no_grad()
    def mel(self, latents: torch.Tensor, prec: Optional[Precision] = None) -> torch.Tensor:
        with no_tf32():
            return self.dae.decode(latents.to(self.device), prec or self.prec)

    @torch.no_grad()
    def audio(self, traffic: dict, mel: torch.Tensor, seed: int, lat_shape: tuple,
              batch: int, rows: slice, prec: Optional[Precision] = None) -> torch.Tensor:
        """The audio decode of the port's mel rows ``rows`` of a ``batch``."""
        prec = prec or self.prec
        mel = mel.to(self.device)
        if traffic["decode_mode"] == "fgla":
            fmt = self.config["format"]
            return self.decoder(mel, fmt["num_fgla_iters"], fmt["fgla_phase_init"], prec)
        dcfg = self.ddec.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        skip_draws(lat_shape, traffic["steps"], gen)
        lin = self.decoder.mel_spec_to_linear(mel)
        shape = self.decoder.mdct_shape(batch, lin.shape[2])
        with no_tf32():
            coeffs = edm_sample(lambda x, s: self.ddec(x, s, None, prec, lin), shape,
                                traffic["steps"], dcfg["sigma_max"], dcfg["sigma_min"],
                                dcfg["sigma_data"], None, gen, rows)
        return self.decoder.mdct_to_raw(coeffs)


def compare(ref: ServeReference, traffic: dict, request: dict,
            control: Optional[ServeReference] = None, detail: bool = False) -> Dict[str, float]:
    """The gaps of one request's checked rows. ``request`` holds its
    ``seed``, prompt ``emb`` (B, E), ``lat_shape``, ``rows`` (a slice of the
    batch) and the outputs on the host: ``latents``, ``mel`` and ``raw`` of
    those rows. With ``control``, the control's own chain stands in the
    port's place."""
    rows, seed, lat_shape = request["rows"], request["seed"], request["lat_shape"]
    batch = lat_shape[0]
    if control is not None:
        lat = control.latents(traffic, lat_shape, seed, request["emb"], rows)
        mel = control.mel(lat)
        raw = control.audio(traffic, mel, seed, lat_shape, batch, rows)
        request = dict(request, latents=lat, mel=mel, raw=raw)
    # the sampler's 100 steps amplify rounding by as much as the weights make
    # them: the latents' gap swings sixfold from seed to seed, and so does
    # the stated precision's own, which sets the scale (on the first
    # checked clip: every clip of a request reads the same)
    want_lat = ref.latents(traffic, lat_shape, seed, request["emb"], rows)
    first = first_row(rows)
    stated = rel_l2(ref.latents(traffic, lat_shape, seed, request["emb"], first, STATED),
                    want_lat[:1])
    gaps = {"latents": rel_l2(request["latents"], want_lat) / stated}
    if detail:
        gaps.update(latents_gap=gaps["latents"] * stated, latents_stated=stated,
                    latents_rows=[rel_l2(a, b) for a, b in zip(request["latents"], want_lat)])
    del want_lat
    # the DAE decode's gap swings fivefold with the weights (0.009-0.06 over
    # 26 seeds), as does the stated precision's own: their ratio is steady
    want_mel = ref.mel(request["latents"])
    stated = rel_l2(ref.mel(request["latents"], STATED), want_mel)
    gaps["mel"] = rel_l2(request["mel"], want_mel) / stated
    if detail:
        gaps.update(mel_gap=gaps["mel"] * stated, mel_stated=stated)
    del want_mel
    want_raw = ref.audio(traffic, request["mel"], seed, lat_shape, batch, rows)
    if traffic["decode_mode"] == "fgla":
        # Griffin-Lim's phases are chaotic: two runs from one mel that round
        # their state differently end far apart in samples, but reach the
        # same consistency with the mel's magnitudes. The number is the gap
        # between the two runs' spectral convergence.
        dec = ref.decoder
        target = dec.magnitudes(request["mel"].to(ref.device))

        def convergence(raw):
            mag = audio.stft(raw.to(ref.device).float(), dec.window, dec.n_fft, dec.hop).abs()
            return rel_l2(mag[..., :target.shape[-2], :], target)
        sc_got, sc_want = convergence(request["raw"]), convergence(want_raw)
        gaps["audio_sc"] = abs(sc_got - sc_want) / sc_want
        if detail:
            gaps["audio"] = rel_l2(request["raw"], want_raw)
            gaps.update(sc_port=sc_got, sc_ref=sc_want)
    else:
        # the DDEC's 100 steps amplify rounding by as much as the weights
        # make them (0.003-0.028 over 14 seeds): scaled as the mel's
        stated = rel_l2(ref.audio(traffic, request["mel"], seed, lat_shape, batch, rows, STATED),
                        want_raw)
        gaps["audio"] = rel_l2(request["raw"], want_raw) / stated
        if detail:
            gaps.update(audio_gap=gaps["audio"] * stated, audio_stated=stated)
    return gaps
