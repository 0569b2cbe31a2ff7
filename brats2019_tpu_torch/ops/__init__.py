"""Kernel seams. Each op runs its plain torch version on a CPU tensor and its
hand-written Hopper kernel on a CUDA tensor, and counts its launches."""

from .conv import conv3d
from .norm import instance_norm_act
from .resize import downsample2x, resize_trilinear, upsample2x

# the four kernel wrappers of the predict path, by name
KERNEL_WRAPPERS = {
    "conv3d": conv3d,
    "instance_norm_act": instance_norm_act,
    "downsample2x": downsample2x,
    "upsample2x": upsample2x,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


__all__ = [
    "KERNEL_WRAPPERS",
    "conv3d",
    "downsample2x",
    "instance_norm_act",
    "launch_counts",
    "reset_launch_counts",
    "resize_trilinear",
    "upsample2x",
]
