"""fgla_roofline.serve: the least time of Griffin-Lim's frame passes and
overlap-adds (bytes and operations from their shapes) over the device time
of the kernels that ran them."""
from benchmark.yardstick.readers import fgla_roofline

#: K2 (frame pass) and K3 (overlap-add and re-framing), each on both routes
KERNELS = ("fgla_frame_hopper_kernel", "fgla_frame_kernel",
           "ola_reframe_hopper_kernel", "ola_reframe_kernel")


def read(run: dict):
    return fgla_roofline(run, KERNELS)
