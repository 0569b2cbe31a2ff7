"""The device program's time a volume: CUDA events around
``Predictor.predict_device`` on the cell's prepared canvases, back to back,
the card synchronised at the end, ms a volume."""


def read(readings, profile):
    if readings.get("kind") != "predict" or not readings.get("program_s"):
        return None
    return 1e3 * readings["program_s"]
