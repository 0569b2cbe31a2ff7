"""The training step's share of the card's bf16 peak: the frozen FLOPs of
a step (``yardstick.train_step_flops``, 3x the forward, at the cell's batch)
over the step time (CUDA events around steps run back to back), in %."""

from perfbench import yardstick


def read(readings, profile):
    if readings.get("kind") != "train" or not readings.get("train_step_s"):
        return None
    return 100.0 * readings["step_flops"] / readings["train_step_s"] / yardstick.PEAK_BF16
