# Copied from dualdiffusion_tpu/utils/audio_metadata.py.
"""Native FLAC metadata (VorbisComment) editing — no mutagen dependency.

The reference's dataset-cleaning loop writes labels / CLAP fields / user
ratings directly into the audio files' tags and reads them back when
(re)building the dataset (reference: src/utils/dual_diffusion_utils.py:
354-419 ``update_audio_metadata`` / ``get_audio_metadata`` via mutagen).
This module reproduces that round-trip for FLAC natively by parsing the
FLAC metadata-block chain (a simple length-prefixed block list before the
audio frames), so the rating workflow needs no external audio library:

  * ``get_audio_metadata(path)``  -> {KEY: [values]} (VorbisComment)
  * ``update_audio_metadata(path, metadata=..., rating=...,
    clear_clap_fields=..., copy_on_write=...)`` — rating is written to the
    same three keys the reference uses (RATING, "RATING WMP", FMPS_RATING)
  * ``get_audio_info(path)`` -> AudioInfo from STREAMINFO (sample rate,
    channels, bit depth, duration) — no decode needed

Non-FLAC files fall back to the ``<file>.json`` sidecar convention used
throughout :mod:`dualdiffusion_tpu.dataset.processes` (ARCHITECTURE.md
§2.8 documents the deviation), so callers get one uniform surface.

FLAC framing reference: https://xiph.org/flac/format.html — 4-byte
"fLaC" magic, then metadata blocks: 1-byte header (bit7 = last-block
flag, bits 0-6 = type; type 0 STREAMINFO, 1 PADDING, 4 VORBIS_COMMENT),
3-byte big-endian payload length. VorbisComment payload (all
little-endian): u32 vendor length + vendor utf-8, u32 comment count,
then per comment u32 length + "KEY=value" utf-8.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

__all__ = ["AudioInfo", "get_audio_info", "get_audio_metadata",
           "update_audio_metadata", "is_flac_file"]

_MAGIC = b"fLaC"
_STREAMINFO, _PADDING, _VORBIS_COMMENT = 0, 1, 4


@dataclass
class AudioInfo:
    sample_rate: int
    channels: int
    bits_per_sample: int = 0
    num_samples: int = 0

    @property
    def duration(self) -> float:
        return self.num_samples / self.sample_rate if self.sample_rate else 0.0


@dataclass
class _Block:
    type: int
    data: bytes
    last: bool = False


def is_flac_file(path: Union[str, Path]) -> bool:
    try:
        with open(path, "rb") as fh:
            return fh.read(4) == _MAGIC
    except OSError:
        return False


def _read_blocks(fh) -> Tuple[List[_Block], bytes]:
    """Parse the metadata-block chain; returns (blocks, audio frames)."""
    if fh.read(4) != _MAGIC:
        raise ValueError("not a FLAC stream (missing fLaC magic)")
    blocks: List[_Block] = []
    while True:
        head = fh.read(4)
        if len(head) != 4:
            raise ValueError("truncated FLAC metadata block header")
        last = bool(head[0] & 0x80)
        btype = head[0] & 0x7F
        length = int.from_bytes(head[1:4], "big")
        data = fh.read(length)
        if len(data) != length:
            raise ValueError("truncated FLAC metadata block payload")
        blocks.append(_Block(btype, data, last))
        if last:
            break
    return blocks, fh.read()


def _write_blocks(fh, blocks: List[_Block], frames: bytes) -> None:
    fh.write(_MAGIC)
    for i, b in enumerate(blocks):
        last = i == len(blocks) - 1
        fh.write(bytes([(0x80 if last else 0) | b.type])
                 + len(b.data).to_bytes(3, "big") + b.data)
    fh.write(frames)


def _parse_vorbis_comment(data: bytes) -> Tuple[str, List[Tuple[str, str]]]:
    off = 0
    (vlen,) = struct.unpack_from("<I", data, off)
    off += 4
    vendor = data[off:off + vlen].decode("utf-8", "replace")
    off += vlen
    (count,) = struct.unpack_from("<I", data, off)
    off += 4
    comments: List[Tuple[str, str]] = []
    for _ in range(count):
        (clen,) = struct.unpack_from("<I", data, off)
        off += 4
        entry = data[off:off + clen].decode("utf-8", "replace")
        off += clen
        key, _, value = entry.partition("=")
        comments.append((key, value))
    return vendor, comments


def _build_vorbis_comment(vendor: str,
                          comments: List[Tuple[str, str]]) -> bytes:
    out = bytearray()
    vb = vendor.encode("utf-8")
    out += struct.pack("<I", len(vb)) + vb
    out += struct.pack("<I", len(comments))
    for key, value in comments:
        entry = f"{key}={value}".encode("utf-8")
        out += struct.pack("<I", len(entry)) + entry
    return bytes(out)


def get_audio_info(path: Union[str, Path]) -> AudioInfo:
    """STREAMINFO fields without decoding (reference:
    dual_diffusion_utils.py:419-428 via mutagen's .info)."""
    with open(path, "rb") as fh:
        blocks, _ = _read_blocks(fh)
    for b in blocks:
        if b.type == _STREAMINFO and len(b.data) >= 34:
            # bytes 10..17: 20-bit sample rate, 3-bit channels-1,
            # 5-bit bps-1, 36-bit total samples
            bits = int.from_bytes(b.data[10:18], "big")
            return AudioInfo(
                sample_rate=(bits >> 44) & 0xFFFFF,
                channels=((bits >> 41) & 0x7) + 1,
                bits_per_sample=((bits >> 36) & 0x1F) + 1,
                num_samples=bits & 0xFFFFFFFFF)
    raise ValueError(f"no STREAMINFO block in {path}")


def _sidecar(path: Union[str, Path]) -> Path:
    return Path(str(path) + ".json")


def get_audio_metadata(path: Union[str, Path]) -> Dict[str, List[str]]:
    """{KEY: [values]} — VorbisComment tags for FLAC, sidecar otherwise.
    Keys keep their stored case; lookups in the dataset pipeline are done
    case-insensitively by callers that need it (Vorbis keys are
    case-insensitive by spec)."""
    if is_flac_file(path):
        with open(path, "rb") as fh:
            blocks, _ = _read_blocks(fh)
        tags: Dict[str, List[str]] = {}
        for b in blocks:
            if b.type == _VORBIS_COMMENT:
                _, comments = _parse_vorbis_comment(b.data)
                for key, value in comments:
                    tags.setdefault(key, []).append(value)
        return tags
    sc = _sidecar(path)
    if sc.is_file():
        with open(sc, "r") as fh:
            data = json.load(fh)
        return {k: v if isinstance(v, list) else [str(v)]
                for k, v in data.items()}
    return {}


def update_audio_metadata(path: Union[str, Path],
                          metadata: Optional[dict] = None,
                          rating: Optional[int] = None,
                          clear_clap_fields: bool = False,
                          copy_on_write: bool = False) -> None:
    """Merge ``metadata`` (and the rating keys) into the file's tags.

    Mirrors the reference's semantics (dual_diffusion_utils.py:354-409):
    ratings land in RATING / "RATING WMP" (0-5 integer) and FMPS_RATING
    (0-1 float); ``clear_clap_fields`` drops every existing ``clap_*``
    tag; non-string values are stringified; ``copy_on_write`` edits a
    copy and atomically renames it over the original.
    """
    metadata = dict(metadata or {})
    if rating is not None:
        metadata.update({
            "RATING": str(rating),
            "RATING WMP": str(rating),
            "FMPS_RATING": f"{rating / 5}",
        })
    if not metadata and not clear_clap_fields:
        return

    metadata = {k: v if isinstance(v, str) else str(v)
                for k, v in metadata.items()}

    if not is_flac_file(path):
        sc = _sidecar(path)
        data: Dict[str, object] = {}
        if sc.is_file():
            with open(sc, "r") as fh:
                data = json.load(fh)
        if clear_clap_fields:
            data = {k: v for k, v in data.items()
                    if not k.lower().startswith("clap_")}
        data.update(metadata)
        tmp = Path(str(sc) + ".tmp")
        with open(tmp, "w") as fh:
            json.dump(data, fh, indent=2)
        os.replace(tmp, sc)
        return

    with open(path, "rb") as fh:
        blocks, frames = _read_blocks(fh)

    vendor = "dualdiffusion_tpu"
    comments: List[Tuple[str, str]] = []
    vc_index = None
    for i, b in enumerate(blocks):
        if b.type == _VORBIS_COMMENT:
            vendor, comments = _parse_vorbis_comment(b.data)
            vc_index = i
            break

    if clear_clap_fields:
        comments = [(k, v) for k, v in comments
                    if not k.lower().startswith("clap_")]
    # replace-by-key (case-insensitive, per Vorbis spec), preserve order
    lowered = {k.lower() for k in metadata}
    comments = [(k, v) for k, v in comments if k.lower() not in lowered]
    comments.extend(metadata.items())

    new_vc = _Block(_VORBIS_COMMENT, _build_vorbis_comment(vendor, comments))
    if vc_index is not None:
        blocks[vc_index] = new_vc
    else:
        # insert after STREAMINFO (which must stay first per spec)
        blocks.insert(1 if blocks and blocks[0].type == _STREAMINFO else 0,
                      new_vc)

    def _save(target: Union[str, Path]) -> None:
        tmp = Path(str(target) + ".meta.tmp")
        try:
            with open(tmp, "wb") as fh:
                _write_blocks(fh, blocks, frames)
            os.replace(tmp, target)
        except BaseException:
            if tmp.is_file():
                tmp.unlink()
            raise

    if copy_on_write:
        tmp_copy = f"{path}.tmp"
        try:
            shutil.copy2(path, tmp_copy)
            _save(tmp_copy)
            os.replace(tmp_copy, path)
        finally:
            if os.path.isfile(tmp_copy):
                os.remove(tmp_copy)
    else:
        _save(path)
