"""How long the card's stream stood empty while the dispatch thread waited
for a prepared canvas, in the traced predict window: the CUDA-event edges of
the program's ``predict.await_prep`` spans (``infer/predictor.py``), summed,
over the number of ``predict.program`` spans (one a volume), ms a volume.
Each call's fill and any prep that falls behind show here; the drain is in
``predict.await_post``. None where the program keeps no spans."""


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
    waits = [s.device_ms for s in spans if s.name == "predict.await_prep"]
    if not volumes or not waits or None in waits:
        return None
    return sum(waits) / volumes
