"""The Swin encoder's device time a volume in the traced predict window:
the CUDA-event edges of the program's ``swin.encoder`` spans
(``models/swin_unetr.py``: the patch embed, the four stages of Swin blocks
and merging, the hidden states), summed, over the number of
``predict.program`` spans (one a volume), ms a volume. None where the
program keeps no such spans."""


def _spans():
    try:
        from brats2019_tpu_torch.utils.profile import snapshot
    except ImportError:
        return None
    return snapshot()


def read(readings, profile):
    if readings.get("kind") != "predict":
        return None
    spans = _spans() or []
    volumes = sum(1 for s in spans if s.name == "predict.program")
    encoder = [s.device_ms for s in spans if s.name == "swin.encoder"]
    if not volumes or not encoder or None in encoder:
        return None
    return sum(encoder) / volumes
