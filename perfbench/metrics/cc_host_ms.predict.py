"""The host's time to enqueue the device connected components, in the
traced predict window: the self time of the program's ``program.cc`` spans
(``models/cascade.py``), their host time less that of their ``cc.sync``
children (the flag reads), over the number of ``predict.program`` spans
(one a volume), ms a volume. At or above the components' device time they
are launch-bound. None where the program keeps no spans."""


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
    cc = [s for s in spans if s.name == "program.cc"]
    if not volumes or not cc:
        return None
    syncs = sum(s.host_ms for s in spans
                if s.name == "cc.sync" and getattr(s.parent, "name", None) == "program.cc")
    return (sum(s.host_ms for s in cc) - syncs) / volumes
