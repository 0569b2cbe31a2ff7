"""The 3x3x3 convs' share of their roofline in the traced training steps:
for every call of the program's conv operators, forward and dgrad
(``brats_torch::conv3d``, ``conv3d_stats``, ``conv3d_winograd``: input
(N, D, H, W, Ci), weight (3, 3, 3, Ci, Co)) and wgrad
(``brats_torch::conv3d_wgrad``: x (N, D, H, W, Ci), gy, w (3, 3, 3, Ci, Co)),
the least time of a direct conv at the call's shapes in bf16
(``yardstick.conv_bound_s``; a wgrad's operations and bytes are those of the
direct conv of the same shapes), summed, over the device time of the kernels
launched under those calls, in %. None where the program has no wgrad
operator."""

from perfbench import yardstick

CONV_OPS = ("brats_torch::conv3d", "brats_torch::conv3d_stats",
            "brats_torch::conv3d_winograd")
WGRAD = "brats_torch::conv3d_wgrad"


def _shape(name, x):
    """(N, D, H, W, Ci, Co) of a call's input shapes, or None."""
    if name in CONV_OPS and len(x) >= 2 and len(x[0]) == 5 and len(x[1]) == 5:
        return tuple(x[0]) + (x[1][4],)
    if name == WGRAD and len(x) >= 3 and len(x[0]) == 5 and len(x[2]) == 5:
        return tuple(x[0]) + (x[2][4],)
    return None


def read(readings, profile):
    if readings.get("kind") != "train" or profile is None:
        return None
    convs = [(_shape(name, x), s, name) for name, x, s in profile.op_calls]
    convs = [c for c in convs if c[0] is not None]
    spent = sum(s for _, s, _ in convs)
    if spent <= 0 or not any(name == WGRAD for _, _, name in convs):
        return None
    return 100.0 * sum(yardstick.conv_bound_s(shape) for shape, _, _ in convs) / spent
