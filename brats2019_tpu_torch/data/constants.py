"""BraTS 2019 dataset constants (copy of ``brats2019_tpu/data/constants.py``).

Disk labels {0,1,2,4} (background, NCR/NET, edema, enhancing tumor) map to
the contiguous internal classes {0,1,2,3}.
"""

import numpy as np

MODALITIES = ("t1", "t1ce", "t2", "flair")
NUM_MODALITIES = 4
NUM_CLASSES = 4  # internal contiguous: bg, NCR/NET, ED, ET

VOLUME_SHAPE = (240, 240, 155)  # canonical BraTS volume (x, y, z)

DISK_LABELS = (0, 1, 2, 4)


def internal_to_disk(labels):
    """Map internal class ids {0,1,2,3} -> BraTS disk labels {0,1,2,4}."""
    out = np.asarray(labels).copy()
    out[out == 3] = 4
    return out


def disk_to_internal(labels):
    """Map BraTS disk labels {0,1,2,4} -> internal contiguous {0,1,2,3}."""
    out = np.asarray(labels).copy()
    out[out == 4] = 3
    return out
