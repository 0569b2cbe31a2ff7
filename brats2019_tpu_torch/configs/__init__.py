from .presets import (
    PRESETS,
    ExperimentConfig,
    InferenceConfig,
    TrainConfig,
    UNetConfig,
    get_preset,
)

__all__ = [
    "PRESETS",
    "ExperimentConfig",
    "InferenceConfig",
    "TrainConfig",
    "UNetConfig",
    "get_preset",
]
