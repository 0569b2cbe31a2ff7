"""The host's time to sample and augment a step's microbatches, in the
traced training steps: the host time of the program's ``train.sample``
spans (``train/step.py``: patch draws, slicing and augmentation enqueued on
the pool's device), summed, over the number of ``train.step`` spans, ms a
step. None where the program keeps no spans."""


def _spans():
    try:
        from brats2019_tpu_torch.utils.profile import snapshot
    except ImportError:
        return None
    return snapshot()


def read(readings, profile):
    if readings.get("kind") != "train":
        return None
    spans = _spans() or []
    steps = sum(1 for s in spans if s.name == "train.step")
    samples = [s.host_ms for s in spans if s.name == "train.sample"]
    if not steps or not samples:
        return None
    return sum(samples) / steps
