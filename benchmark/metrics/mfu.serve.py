"""mfu.serve: the model FLOPs of the window's requests (UNet, DAE decode
and DDEC convs and attention, counted from shapes) over the window's
seconds, as a share of the bf16 peak."""
from benchmark.yardstick.readers import window_mfu


def read(run: dict):
    return window_mfu(run)
