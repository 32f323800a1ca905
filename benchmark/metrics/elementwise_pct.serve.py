"""elementwise_pct.serve: the share of the traced parts' device time spent
in PyTorch's elementwise kernels."""
from benchmark.yardstick.readers import device_share
from benchmark.yardstick.trace import ELEMENTWISE


def read(run: dict):
    return device_share(run, lambda name: any(k in name for k in ELEMENTWISE))
