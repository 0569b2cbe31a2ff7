"""The host's time to prepare one volume inside the pipelined predict
window: the mean host time of the program's ``predict.prep`` spans (brain
box, crop, cast, memo, pinned copy enqueued; ``infer/predictor.py``) in the
prep threads, under the post threads' and the dispatch thread's contention,
ms a volume. ``host_prep_ms.predict`` times the same work alone. None where
the program keeps no spans."""


def _spans():
    try:
        from brats2019_tpu_torch.utils.profile import snapshot
    except ImportError:
        return None
    return snapshot()


def read(readings, profile):
    if readings.get("kind") != "predict":
        return None
    preps = [s.host_ms for s in _spans() or [] if s.name == "predict.prep"]
    if not preps:
        return None
    return sum(preps) / len(preps)
