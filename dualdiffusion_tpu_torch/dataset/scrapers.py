# Copied from dualdiffusion_tpu/dataset/scrapers.py.
"""Dataset acquisition and maintenance utilities (reference:
src/dataset/utils/ — zophar.net and joshw.info game-music scrapers, py7zr
unzip, SPC fix, folder compare, file-type lister).

The local utilities (archive extraction, folder comparison, the file-type
census, SPC tag reading and fixing) need no network. The web scrapers
``scrape_zophar``/``scrape_joshw`` download archives and so need the
network: they probe DNS first and raise ``RuntimeError`` when the lookup
fails. Offline, fetch on a connected machine and bring the tree in with
``dataset_process import``.
"""

from __future__ import annotations

import logging
import os
import zipfile
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# archive extraction (reference: src/dataset/utils/unzip.py)
# ---------------------------------------------------------------------------

def extract_archives(root: str, output_dir: Optional[str] = None,
                     remove_archives: bool = False) -> List[str]:
    """Extract every .zip (stdlib) and .7z (if py7zr is importable) under
    ``root``. Returns the list of extracted archive paths."""
    out: List[str] = []
    try:
        import py7zr  # type: ignore
    except ImportError:
        py7zr = None
    for p in sorted(Path(root).rglob("*")):
        dest = Path(output_dir) if output_dir else p.parent
        if p.suffix.lower() == ".zip":
            with zipfile.ZipFile(p) as z:
                z.extractall(dest / p.stem)
            out.append(str(p))
        elif p.suffix.lower() == ".7z":
            if py7zr is None:
                logger.warning("%s: py7zr not available, skipping", p)
                continue
            with py7zr.SevenZipFile(p) as z:
                z.extractall(dest / p.stem)
            out.append(str(p))
        else:
            continue
        if remove_archives:
            p.unlink()
    return out


# ---------------------------------------------------------------------------
# folder compare (reference: src/dataset/utils/folder_compare.py)
# ---------------------------------------------------------------------------

def compare_folders(a: str, b: str) -> Dict[str, List[str]]:
    """Relative paths only in a, only in b, and present in both but with
    differing sizes."""
    fa = {str(p.relative_to(a)): p.stat().st_size
          for p in Path(a).rglob("*") if p.is_file()}
    fb = {str(p.relative_to(b)): p.stat().st_size
          for p in Path(b).rglob("*") if p.is_file()}
    return {
        "only_a": sorted(set(fa) - set(fb)),
        "only_b": sorted(set(fb) - set(fa)),
        "size_mismatch": sorted(k for k in set(fa) & set(fb)
                                if fa[k] != fb[k]),
    }


# ---------------------------------------------------------------------------
# file-type census (reference: src/dataset/utils/list_file_types.py)
# ---------------------------------------------------------------------------

def list_file_types(root: str) -> Dict[str, int]:
    """Extension -> count census of a tree."""
    counts: Counter = Counter()
    for p in Path(root).rglob("*"):
        if p.is_file():
            counts[p.suffix.lower() or "<none>"] += 1
    return dict(counts.most_common())


# ---------------------------------------------------------------------------
# scrapers (network-bound; reference: src/dataset/utils/*scraper*)
# ---------------------------------------------------------------------------

def _require_network() -> None:
    import socket
    try:
        socket.getaddrinfo("example.com", 443)
    except OSError as e:
        raise RuntimeError(
            "scrapers require network access; this environment is "
            "zero-egress. Run them on a connected machine and import the "
            "downloaded tree with dataset_process import.") from e


def scrape_zophar(console: str, output_dir: str,
                  max_items: Optional[int] = None) -> List[str]:
    """Download game-music archives for a console from zophar.net
    (reference workflow: index page -> per-game pages -> archive links)."""
    _require_network()
    import re
    import urllib.request
    base = "https://www.zophar.net"
    index = urllib.request.urlopen(f"{base}/music/{console}").read().decode()
    links = re.findall(rf'href="(/music/{re.escape(console)}/[^"]+)"', index)
    out: List[str] = []
    os.makedirs(output_dir, exist_ok=True)
    for link in links[:max_items]:
        page = urllib.request.urlopen(base + link).read().decode()
        dl = re.findall(r'href="(https://[^"]+\.(?:zip|7z))"', page)
        for url in dl[:1]:
            dest = Path(output_dir) / Path(url).name
            if not dest.exists():
                urllib.request.urlretrieve(url, dest)
            out.append(str(dest))
    return out


def scrape_joshw(system: str, output_dir: str,
                 max_items: Optional[int] = None) -> List[str]:
    """Download archives from the joshw.info archive listing."""
    _require_network()
    import re
    import urllib.request
    base = f"https://{system}.joshw.info"
    index = urllib.request.urlopen(base).read().decode()
    links = re.findall(r'href="([^"]+\.7z)"', index)
    out: List[str] = []
    os.makedirs(output_dir, exist_ok=True)
    for link in links[:max_items]:
        dest = Path(output_dir) / Path(link).name
        if not dest.exists():
            urllib.request.urlretrieve(f"{base}/{link}", dest)
        out.append(str(dest))
    return out


# ---------------------------------------------------------------------------
# SPC (SNES-SPC700) length / fade tag fixing
# ---------------------------------------------------------------------------
# Emulator-ripped SPC files often carry absurdly short play lengths, which
# makes the transcoded FLACs truncate mid-song. The reference bulk-edits the
# length/fade fields in place before transcoding
# (reference: src/dataset/utils/spc_fix.py:64-262). This is a clean-room
# reimplementation of the same public file format:
#   * header "SNES-SPC700 Sound File Data" at offset 0; byte 35 == 26/27
#     marks an id666 tag whose song-length (seconds) lives at offset 169
#     (3 ASCII digits, or 3-byte LE int in the binary variant) and fade
#     (milliseconds) at 172 (5 ASCII digits / 4-byte LE int).
#   * optional extended "xid6" chunk (usually at 66048): 4-byte size then
#     (id, type, size) subchunks; ids 48/49/50/51 hold intro/loop/end/fade
#     lengths in 1/64000 s ticks (type-0 subchunks store the value in the
#     size field).
#   * optional APEv2 tag ("APETAGEX", version 2000): items of
#     (size, flags, NUL-terminated key, value); keys "spc_length" (ms)
#     and "spc_fade" (ms).

_SPC_HEADER = b"SNES-SPC700 Sound File Data"


def _spc_id666_is_binary(data: bytes) -> bool:
    """Heuristics matching the reference (spc_fix.py:92-116), applied in
    the reference's ORDER: the byte-176 guess first (in the text layout
    176 is the 5th fade digit, so a >=10000 ms text fade trips it), then
    the binary-bounds sanity check that rescues such files (any 3 ASCII
    digits at 169 read as a LE int >> 3600), then the ASCII-digit test."""
    binary = data[176] != 0
    if (int.from_bytes(data[169:172], "little") > 3600
            or int.from_bytes(data[172:176], "little") > 30000):
        binary = False
    txt = data[169:172].split(b"\x00")[0].decode("utf-8", "replace")
    if not (txt.isdigit() or txt == ""):
        binary = True
    return binary


def spc_read_tags(path: str) -> Dict[str, Optional[int]]:
    """Read every length/fade field of an SPC file (seconds / ms)."""
    data = Path(path).read_bytes()
    if not data.startswith(_SPC_HEADER):
        raise ValueError(f"{path}: not an SPC file")
    out: Dict[str, Optional[int]] = {
        "length_s": None, "fade_ms": None, "xid6_fade_ms": None,
        "apev2_length_s": None, "apev2_fade_ms": None,
    }
    if data[35] in (26, 27):
        if _spc_id666_is_binary(data):
            out["length_s"] = int.from_bytes(data[169:172], "little")
            out["fade_ms"] = int.from_bytes(data[172:176], "little")
        else:
            try:
                out["length_s"] = int(data[169:172].split(b"\x00")[0] or b"0")
                f = data[172:177].split(b"\x00")[0]
                out["fade_ms"] = int(f) if f else 0
            except ValueError:
                pass
    for key, _, val_off, size, binary in _spc_iter_aux_fields(data):
        if key == "xid6_fade":
            out["xid6_fade_ms"] = int.from_bytes(
                data[val_off:val_off + 4], "little") // 64
        elif key == "apev2_spc_length" and size > 0:
            out["apev2_length_s"] = int(data[val_off:val_off + size]
                                        .split(b"\x00")[0]) // 1000
        elif key == "apev2_spc_fade" and size > 0:
            out["apev2_fade_ms"] = int(data[val_off:val_off + size]
                                       .split(b"\x00")[0])
    return out


def _spc_iter_aux_fields(data: bytes):
    """Yield (key, field_offset, value_offset, size, is_binary) for the
    xid6 fade subchunk and APEv2 spc_length/spc_fade items."""
    # xid6 chunk: standard location 66048, else scan — but only PAST the
    # fixed-size header + SPC700 RAM image (0..66048), which is program /
    # sample data and can contain the bytes "xid6" by chance; a false
    # match there would make spc_fix overwrite music data in place.
    pos = 66048 if data[66048:66052] == b"xid6" else data.find(b"xid6", 66048)
    if pos >= 0 and data[pos:pos + 4] == b"xid6":
        size = int.from_bytes(data[pos + 4:pos + 8], "little") // 4 * 4
        p, end = pos + 8, pos + 8 + size
        while p + 4 <= min(end, len(data)):
            sub_id, sub_type = data[p], data[p + 1]
            sub_size = int.from_bytes(data[p + 2:p + 4], "little")
            sub_size = 0 if sub_type == 0 else sub_size // 4 * 4
            if p + 4 + sub_size > len(data):
                break
            if sub_id == 51 and sub_size >= 4:   # fadeout, 1/64000 s ticks
                yield "xid6_fade", p, p + 4, 4, True
            p += 4 + sub_size
    # APEv2 tag
    pos = data.find(b"APETAGEX")
    if pos >= 0 and int.from_bytes(data[pos + 8:pos + 12], "little") == 2000:
        count = int.from_bytes(data[pos + 16:pos + 20], "little")
        p = pos + 32
        for _ in range(count):
            if p + 8 > len(data):
                break
            item_size = int.from_bytes(data[p:p + 4], "little")
            key_end = data.find(b"\x00", p + 8)
            if key_end < 0:
                break
            key = data[p + 8:key_end].decode("utf-8", "replace").lower()
            val_off = key_end + 1
            if key in ("spc_length", "spc_fade"):
                yield f"apev2_{key}", p, val_off, item_size, False
            p = val_off + item_size


def spc_fix(path: str, ignore_under_s: int = 18, min_length_s: int = 50,
            fade_ms: Optional[int] = 0) -> bool:
    """Raise too-short SPC play lengths to ``min_length_s`` and optionally
    rewrite every fade field to ``fade_ms``; returns True if modified.

    Lengths under ``ignore_under_s`` (jingles) are left alone, except an
    explicit 0 which is treated as missing and raised. All three tag
    locations (id666, xid6, APEv2) are kept consistent.
    (Reference behavior: src/dataset/utils/spc_fix.py:222-246.)
    """
    p = Path(path)
    data = bytearray(p.read_bytes())
    if not data.startswith(_SPC_HEADER):
        raise ValueError(f"{path}: not an SPC file")
    tags = spc_read_tags(path)
    changed = False

    def put_text(off: int, width: int, value: int) -> None:
        s = str(value).encode()
        if len(s) > width:  # the field cannot grow in place
            raise ValueError(f"{path}: {value} does not fit a {width}-byte tag field")
        data[off:off + width] = s.ljust(width, b"\x00")

    if data[35] in (26, 27) and tags["length_s"] is not None:
        binary = _spc_id666_is_binary(bytes(data))
        L = tags["length_s"]
        if (L == 0 or L >= ignore_under_s) and L < min_length_s:
            if binary:
                data[169:172] = int(min_length_s).to_bytes(3, "little")
            else:
                put_text(169, 3, min_length_s)
            changed = True
        if fade_ms is not None and tags["fade_ms"] not in (None, fade_ms):
            if binary:
                data[172:176] = int(fade_ms).to_bytes(4, "little")
            else:
                put_text(172, 5, fade_ms)
            changed = True
    for key, _, val_off, size, _bin in _spc_iter_aux_fields(bytes(data)):
        if key == "xid6_fade" and fade_ms is not None \
                and tags["xid6_fade_ms"] not in (None, fade_ms):
            data[val_off:val_off + 4] = (fade_ms * 64).to_bytes(4, "little")
            changed = True
        elif key == "apev2_spc_length" and size > 0:
            L = tags["apev2_length_s"]
            if L is not None and ignore_under_s <= L < min_length_s:
                put_text(val_off, size, min_length_s * 1000)
                changed = True
        elif key == "apev2_spc_fade" and size > 0 and fade_ms is not None \
                and tags["apev2_fade_ms"] not in (None, fade_ms):
            put_text(val_off, size, fade_ms)
            changed = True
    if changed:
        p.write_bytes(bytes(data))
    return changed


def spc_fix_tree(root: str, ignore_under_s: int = 18,
                 min_length_s: int = 50, fade_ms: Optional[int] = 0
                 ) -> Tuple[int, int]:
    """Apply :func:`spc_fix` to every .spc under ``root``; returns
    (processed, modified) counts."""
    processed = modified = 0
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.lower().endswith(".spc"):
                modified += int(spc_fix(os.path.join(dirpath, f),
                                        ignore_under_s, min_length_s,
                                        fade_ms))
                processed += 1
    return processed, modified
