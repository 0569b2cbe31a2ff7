"""The share of the traced predict window in which nothing ran on the
device: 1 - (union of kernel, copy and fill intervals) / window, in %."""


def read(readings, profile):
    if readings.get("kind") != "predict" or profile is None or profile.window_s <= 0:
        return None
    return 100.0 * (1.0 - profile.busy_s / profile.window_s)
