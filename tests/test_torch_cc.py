"""PyTorch port: device connected components and postprocessing
(``ops/connected_components.py``) against the JAX package's, on the masks of
``tests/test_connected_components.py``: ids, sizes and filtered labels equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brats2019_tpu.infer.postprocess import postprocess_labels as ref_postprocess
from brats2019_tpu.models.cascade import _postprocess_device as ref_postprocess_device
from brats2019_tpu.ops import connected_components as ref_cc
from brats2019_tpu_torch.ops import connected_components as cc
from cc_masks import MASKS


@pytest.mark.parametrize("name", sorted(MASKS))
def test_component_ids_equal_reference(name):
    fg, kw = MASKS[name]
    want = np.asarray(ref_cc.label_components(jnp.asarray(fg), **kw))
    got = cc.label_components(torch.from_numpy(fg), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("check_every", [1, 5, 8, 64])
def test_check_interval_does_not_change_ids(check_every):
    for name in ("blobs0", "snake_needs_jump"):
        fg, kw = MASKS[name]
        want = np.asarray(ref_cc.label_components(jnp.asarray(fg), **kw))
        if kw.get("max_pool_iters", 192) % check_every:
            continue
        got = cc.label_components(torch.from_numpy(fg), check_every=check_every, **kw)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,max_components", [
    ("blobs0", 128), ("blobs1", 8), ("sparse_grid", 16), ("sparse_grid", 128),
    ("snake_plane", 128), ("empty", 128), ("full", 4),
])
def test_component_sizes_equal_reference(name, max_components):
    fg, _ = MASKS[name]
    comp = np.asarray(ref_cc.label_components(jnp.asarray(fg)))
    want = np.asarray(ref_cc.component_sizes(jnp.asarray(comp),
                                             max_components=max_components))
    got = cc.component_sizes(torch.from_numpy(comp), max_components=max_components)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "sparse_grid" and max_components == 16:
        fg_sizes = got.numpy()[comp > 0]       # 48 unmeasured, read huge, kept
        assert (fg_sizes >= 2 ** 30).sum() == 64 - 16


def _label_volume(seed):
    rng = np.random.default_rng(seed)
    labels = np.zeros((20, 20, 20), np.uint8)
    labels[2:10, 2:10, 2:10] = rng.integers(1, 4, size=(8, 8, 8))
    labels[15, 15, 15] = 1
    labels[0, 0, 0:3] = 3
    labels[13:15, 3:5, 17] = 2
    return labels


@pytest.mark.parametrize("min_voxels", [0, 1, 4, 8, 600])
def test_filtered_labels_equal_reference(min_voxels):
    labels = _label_volume(0)
    want = ref_cc.filter_small_components_device(labels, min_voxels)
    got = cc.filter_small_components_device(labels, min_voxels, device="cpu")
    assert got.dtype == labels.dtype
    np.testing.assert_array_equal(got, np.asarray(want))


def test_filter_defaults_to_the_card():
    """The JAX function runs on the default device; the port's on the card
    unless the caller asks for the CPU (here, without one, the request
    fails instead of running on the CPU)."""
    import inspect

    assert inspect.signature(cc.filter_small_components_device).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            cc.filter_small_components_device(_label_volume(0), 4)


@pytest.mark.parametrize("min_voxels,et_min", [(16, 32), (4, 0), (0, 32), (200, 500)])
def test_postprocess_labels_backends_agree(min_voxels, et_min):
    """``postprocess_labels(backend=...)`` as the reference's: the device
    backend (here on the CPU) gives the scipy backend's labels and the JAX
    package's device backend's."""
    from brats2019_tpu.infer.postprocess import postprocess_labels as ref_post
    from brats2019_tpu_torch.infer.postprocess import postprocess_labels

    labels = _label_volume(3)
    kw = dict(min_component_voxels=min_voxels, et_min_voxels=et_min)
    scipy_ = postprocess_labels(labels, **kw)
    dev = postprocess_labels(labels, backend="device", device="cpu", **kw)
    np.testing.assert_array_equal(dev, scipy_)
    np.testing.assert_array_equal(dev, np.asarray(ref_post(labels, backend="device", **kw)))


@pytest.mark.parametrize("min_voxels,et_min", [(16, 32), (4, 0), (0, 32), (8, 500)])
def test_postprocess_device_equals_reference(min_voxels, et_min):
    """Including the tiny-ET -> NCR relabel (the volume holds ~170 ET voxels,
    so et_min 500 relabels and 32 does not), against the JAX in-graph
    version and the host scipy one."""
    labels = _label_volume(1)
    want = np.asarray(ref_postprocess_device(jnp.asarray(labels), min_voxels, et_min))
    got = cc.postprocess_device(torch.from_numpy(labels), min_voxels, et_min)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), ref_postprocess(labels, min_component_voxels=min_voxels,
                                     et_min_voxels=et_min))


def test_tiny_et_relabelled_to_ncr():
    labels = np.zeros((8, 8, 8), np.uint8)
    labels[1:5, 1:5, 1:5] = 2
    labels[2:4, 2:4, 2:4] = 3                  # 8 ET voxels inside the blob
    got = cc.postprocess_device(torch.from_numpy(labels), 4, 32).numpy()
    want = np.asarray(ref_postprocess_device(jnp.asarray(labels), 4, 32))
    np.testing.assert_array_equal(got, want)
    assert (got[2:4, 2:4, 2:4] == 1).all() and (got == 3).sum() == 0


def test_too_many_voxels_for_exact_ids_raise():
    with pytest.raises(ValueError, match="exact"):
        cc.label_components(torch.zeros((256, 256, 256), dtype=torch.bool))


def test_label_components_is_an_operator_with_a_fake():
    """``brats_torch::label_components`` is registered: on the CPU it runs
    the plain form and counts no kernel call; its fake gives int32 of the
    mask's shape, which is what ``torch.export`` traces with."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op = torch.ops.brats_torch.label_components.default
    assert cc.label_components_op is op
    fg = torch.from_numpy(MASKS["blobs0"][0])
    before = cc.label_components.launches
    got = op(fg, 192, 64, 8)
    assert cc.label_components.launches == before
    np.testing.assert_array_equal(got.numpy(), cc._label_plain(fg, 192, 64, 8).numpy())
    with FakeTensorMode():
        fake = op(torch.empty((6, 7, 5), dtype=torch.bool), 192, 64, 8)
    assert fake.dtype == torch.int32 and tuple(fake.shape) == (6, 7, 5)


def test_label_components_kernel_refuses_a_cpu_tensor():
    """The CUDA implementation raises on what it does not take; a CPU tensor
    never reaches it through the operator."""
    with pytest.raises(RuntimeError, match="CUDA"):
        cc.label_components_kernel(torch.zeros((4, 4, 4), dtype=torch.bool),
                                   192, 64, 8)
