"""PyTorch port: UNet3D logits against the JAX model through the weight
bridge, in f32 on the CPU, at the golden-parity bar of
tests/test_golden_parity.py:122 (atol 2e-4, rtol 1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brats2019_tpu.models import unet3d as jax_unet
from brats2019_tpu.train.checkpoint import export_params
from brats2019_tpu_torch.configs.presets import UNetConfig
from brats2019_tpu_torch.models import unet3d
from brats2019_tpu_torch.utils.weights import build_unet


def _pair(tmp_path, kw, shape, seed=0):
    jm = jax_unet.UNet3D(jax_unet.UNetConfig(**kw))
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros(shape))
    path = str(tmp_path / "params.npz")
    export_params(path, params)
    return jm, params, build_unet(UNetConfig(**kw), path)


@pytest.mark.parametrize("stem,subpixel,shape", [
    (1, True, (2, 16, 16, 16, 4)),
    (2, True, (2, 16, 16, 16, 4)),
    (2, False, (2, 16, 16, 16, 4)),
    (2, True, (1, 24, 32, 16, 4)),     # non-cubic, coarse-grid-like
])
def test_unet_logits_match_jax(tmp_path, stem, subpixel, shape):
    kw = dict(levels=3, base_features=8, max_features=16,
              compute_dtype="float32", stem_downsample=stem)
    jm, params, tm = _pair(tmp_path, kw, shape)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x), subpixel=subpixel))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), subpixel=subpixel).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("r", [2, 3])
def test_space_to_depth_channel_order_matches_jax(r):
    x = np.random.default_rng(3).normal(size=(2, 6, 12, 6, 3)).astype(np.float32)
    s2d = unet3d.space_to_depth(torch.from_numpy(x), r)
    np.testing.assert_array_equal(
        s2d.numpy(), np.asarray(jax_unet.space_to_depth(jnp.asarray(x), r))
    )
    d2s = unet3d.depth_to_space(s2d, r)
    np.testing.assert_array_equal(d2s.numpy(), x)
    np.testing.assert_array_equal(
        d2s.numpy(),
        np.asarray(jax_unet.depth_to_space(jnp.asarray(s2d.numpy()), r)),
    )


def test_unet_bf16_compute_keeps_f32_logits():
    kw = dict(levels=2, base_features=4, max_features=8, stem_downsample=2)
    from brats2019_tpu_torch.utils.weights import init_params

    tm = build_unet(UNetConfig(**kw), init_params(UNetConfig(**kw), seed=1))
    x = torch.randn(1, 8, 8, 8, 4)
    with torch.no_grad():
        logits = tm(x)
        lowres = tm(x, subpixel=False)
    assert logits.dtype == torch.float32 and logits.shape == (1, 8, 8, 8, 4)
    assert lowres.shape == (1, 4, 4, 4, 32)
    assert torch.isfinite(logits).all()


def test_conv_kernel_cast_once_on_load():
    """The compute-dtype kernel copy follows every load and is not saved."""
    from brats2019_tpu_torch.models.blocks import Conv3x3
    from brats2019_tpu_torch.utils.weights import init_params

    cfg = UNetConfig(levels=2, base_features=4, max_features=8)
    tm = build_unet(cfg, init_params(cfg, seed=2))
    convs = [m for m in tm.modules() if isinstance(m, Conv3x3)]
    assert len(convs) == 6
    for m in convs:
        assert m.kernel.dtype == torch.float32
        assert torch.equal(m.kernel_c, m.kernel.bfloat16())
    assert not any(k.endswith("kernel_c") for k in tm.state_dict())
