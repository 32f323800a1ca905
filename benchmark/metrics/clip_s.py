"""clip_s: wall seconds of the window over the clips it completed (every
request whole, its outputs on the host)."""


def read(run: dict):
    w = run["window"]
    return w["seconds"] / w["clips"] if w.get("clips") else None
