"""The whole predict program's share of the card's bf16 peak: the frozen
conv FLOPs of a volume's program (``yardstick.predict_program_flops``) over
``program_ms.predict``'s time, in %."""

from perfbench import yardstick


def read(readings, profile):
    if readings.get("kind") != "predict" or not readings.get("program_s"):
        return None
    return 100.0 * readings["volume_flops"] / readings["program_s"] / yardstick.PEAK_BF16
