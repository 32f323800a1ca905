"""k1_roofline.serve: the least time of the profiled UNet forwards' grouped
3x3 convs (operations and bytes from their shapes) over the device time of
the kernels that ran them."""
from benchmark.yardstick.readers import k1_forward_roofline

#: K1 forward: the Hopper kernel and the WMMA one (channel counts not multiples of 8)
KERNELS = ("conv3x3_hopper_kernel", "grouped_conv3x3_kernel")


def read(run: dict):
    return k1_forward_roofline(run, KERNELS)
