"""Kernel seams. Each op runs its plain torch version on a CPU tensor and its
hand-written Hopper kernel on a CUDA tensor, and counts its launches. The
forward kernels of the predict path, the device connected components and the
Swin UNETR's window attention (whose ``launches`` counts its calls on either
device, ``launches_cuda`` its kernel's launches) are
``torch.library`` operators in the namespace ``brats_torch``
(``ops/library.py``), defined when this package is imported: a consumer of an
exported program needs this import and nothing else of the port."""

from .connected_components import label_components
from .conv import conv3d, get_backend, set_backend
from .norm import instance_norm_act, instance_norm_act_bwd, instance_norm_partials
from .resize import (
    downsample2x,
    downsample2x_bwd,
    resize_trilinear,
    upsample2x,
    upsample2x_bwd,
    upsample2x_concat,
)
from .winograd import conv3d_winograd
from .window_attention import window_attention

# the kernel wrappers by name: the four forwards of the predict path (the
# conv's dgrad counts under conv3d), then the three backward kernels of
# the training path, then the Winograd conv (the conv seam's second backend),
# then the device connected components (a call each)
KERNEL_WRAPPERS = {
    "conv3d": conv3d,
    "instance_norm_act": instance_norm_act,
    "downsample2x": downsample2x,
    "upsample2x": upsample2x,
    "instance_norm_act_bwd": instance_norm_act_bwd,
    "downsample2x_bwd": downsample2x_bwd,
    "upsample2x_bwd": upsample2x_bwd,
    "conv3d_winograd": conv3d_winograd,
    "label_components": label_components,
    "window_attention": window_attention,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    conv3d.launches_wgmma = 0   # the share of conv3d.launches on conv3d_wgmma.cu
    conv3d.launches_stats = 0   # of those, with the InstanceNorm-statistics epilogue
    instance_norm_act.launches_partials = 0   # IN+act from the conv's partials
    instance_norm_act.launches_shard_stats = 0   # a shard's statistics pass alone
    upsample2x.launches_cuda = 0     # the 2x up on resize2x.cu
    downsample2x.launches_cuda = 0   # the 2x down on resize2x.cu (f32)
    upsample2x.launches_concat = 0   # of those, into the decoder's concat buffer
    conv3d_winograd.launches_wgmma = 0   # likewise, on winograd3d_wgmma.cu
    instance_norm_act_bwd.launches_cuda = 0   # the IN+act backward on in_act_bwd.cu
    upsample2x_bwd.launches_cuda = 0     # the 2x up backward on resize2x.cu
    downsample2x_bwd.launches_cuda = 0   # the 2x down backward on resize2x.cu (f32)
    window_attention.launches_cuda = 0   # window_attention.cu launches (the calls count either device)
    window_attention.tokens = 0          # window tokens attended, padding included
    window_attention.padded_tokens = 0   # of those, the padding's
    for fn in KERNEL_WRAPPERS.values():
        fn.launches_f32 = 0              # those on the f32 routes


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


__all__ = [
    "KERNEL_WRAPPERS",
    "conv3d",
    "conv3d_winograd",
    "downsample2x",
    "downsample2x_bwd",
    "get_backend",
    "instance_norm_act",
    "instance_norm_act_bwd",
    "instance_norm_partials",
    "label_components",
    "launch_counts",
    "reset_launch_counts",
    "resize_trilinear",
    "set_backend",
    "upsample2x",
    "upsample2x_bwd",
    "upsample2x_concat",
    "window_attention",
]
