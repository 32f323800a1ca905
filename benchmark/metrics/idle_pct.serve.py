"""idle_pct.serve: the share of the traced parts' wall time in which no
operation ran on the device."""
from benchmark.yardstick.readers import idle_pct


def read(run: dict):
    return idle_pct(run)
