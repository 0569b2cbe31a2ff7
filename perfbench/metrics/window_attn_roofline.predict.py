"""The Swin window attention's share of its roofline in the traced predict
window: for every call of the program's ``brats_torch::window_attention``
operator (inputs qkv (windows, T, 3C) bf16 and the relative-position table
(rows, heads) f32), the least time of the call
(``reference/swin_unetr.py`` ``window_attention_terms``: the larger of its
bytes over 3.35 TB/s and its FLOPs over 989 TFLOP/s), summed, over the
device time of the kernels launched under those calls, in %. None where the
program has no such operator."""

from perfbench import yardstick
from perfbench.reference.swin_unetr import window_attention_terms

OP = "brats_torch::window_attention"


def read(readings, profile):
    if readings.get("kind") != "predict" or profile is None:
        return None
    calls = [(x, s) for name, x, s in profile.op_calls
             if name == OP and len(x) >= 2 and len(x[0]) == 3 and len(x[1]) == 2]
    spent = sum(s for _, s in calls)
    if spent <= 0:
        return None
    bound = 0.0
    for x, _ in calls:
        nbytes, flops = window_attention_terms(x)
        bound += max(nbytes / yardstick.PEAK_BW, flops / yardstick.PEAK_BF16)
    return 100.0 * bound / spent
