"""How long the card's stream stood empty while the device connected
components waited for their convergence flags, in the traced predict
window: the CUDA-event edges of the program's ``cc.sync`` spans (one a host
read of ``label_components``, ``ops/connected_components.py``), summed, over
the number of ``predict.program`` spans (one a volume), ms a volume. None
where the program keeps no spans."""


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
    syncs = [s.device_ms for s in spans if s.name == "cc.sync"]
    if not volumes or not syncs or None in syncs:
        return None
    return sum(syncs) / volumes
