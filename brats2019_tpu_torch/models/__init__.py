from .unet3d import UNet3D, depth_to_space, space_to_depth

__all__ = ["UNet3D", "depth_to_space", "space_to_depth"]
