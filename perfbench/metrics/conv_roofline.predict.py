"""The 3x3x3 convs' share of their roofline in the traced predict window:
for every call of the program's conv operators (``brats_torch::conv3d``,
``conv3d_stats``, ``conv3d_winograd``), the least time of a direct conv at
the call's shapes in bf16 (``yardstick.conv_bound_s``: the larger of its
bytes over 3.35 TB/s and its FLOPs over 989 TFLOP/s), summed, over the device
time of the kernels launched under those calls, in %."""

from perfbench import yardstick

CONV_OPS = ("brats_torch::conv3d", "brats_torch::conv3d_stats",
            "brats_torch::conv3d_winograd")


def read(readings, profile):
    if readings.get("kind") != "predict" or profile is None:
        return None
    convs = [(tuple(x[0]) + (x[1][4],), s) for name, x, s in profile.op_calls
             if name in CONV_OPS and len(x) >= 2 and len(x[0]) == 5 and len(x[1]) == 5]
    spent = sum(s for _, s in convs)
    if spent <= 0:
        return None
    return 100.0 * sum(yardstick.conv_bound_s(shape) for shape, _ in convs) / spent
