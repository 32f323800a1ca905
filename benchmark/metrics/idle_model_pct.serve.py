"""idle_model_pct.serve: the share of the traced parts' wall time in which
the device ran nothing while the host was inside the program's
``dd.model.*`` spans (the innermost span open at each gap's middle)."""
from benchmark.yardstick.spans import idle_pct


def read(run: dict):
    return idle_pct(run, "model")
