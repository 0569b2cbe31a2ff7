"""Host time to prepare one volume for the device: the host clock around
``Predictor.prepare`` (brain box, bucketed crop, bf16 cast, pinned copy
enqueued), on the cell's volumes one at a time, ms a volume."""


def read(readings, profile):
    prep = readings.get("host_prep_s")
    if readings.get("kind") != "predict" or not prep:
        return None
    return 1e3 * sum(prep) / len(prep)
