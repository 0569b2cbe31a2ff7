"""The masks of the device connected-components tests, without jax: the
CPU tests (``tests/test_torch_cc.py``) hold the port to the JAX package on
them, the card tests (``tests/test_torch_kernels_gpu.py``) hold the kernel to
the CPU form."""

import numpy as np


def random_blobs(seed, shape=(24, 24, 24), p=0.12):
    return np.random.default_rng(seed).random(shape) < p


def snake(shape, axis_plane):
    """A boustrophedon 1-voxel path: one component of large graph diameter."""
    m = np.zeros(shape, bool)
    rows, cols = (shape[1], shape[2]) if axis_plane == 0 else (shape[0], shape[1])
    for r in range(0, rows, 2):
        end = (cols - 1) if (r // 2) % 2 == 0 else 0
        if axis_plane == 0:
            m[0, r, :] = True
            if r + 1 < rows:
                m[0, r + 1, end] = True
        else:
            m[r, :, 1] = True
            if r + 1 < rows:
                m[r + 1, end, 1] = True
    return m


def sparse_grid():
    vol = np.zeros((16, 16, 16), bool)
    vol[1::4, 1::4, 1::4] = True          # 64 single-voxel components
    return vol


MASKS = {
    "blobs0": (random_blobs(0), {}),
    "blobs1": (random_blobs(1), {}),
    "blobs2": (random_blobs(2), {}),
    "sparse_grid": (sparse_grid(), {}),
    "snake_plane": (snake((1, 24, 24), 0), {}),
    # diameter ~512 >> the 24-iteration pool cap: phase 2 must finish it
    "snake_needs_jump": (snake((32, 32, 3), 1), {"max_pool_iters": 24}),
    "empty": (np.zeros((8, 8, 8), bool), {}),
    "full": (np.ones((6, 7, 5), bool), {}),
}
