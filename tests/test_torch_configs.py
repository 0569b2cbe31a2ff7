"""PyTorch port: configs, the weight bridge, and the guards that keep the
port jax-free, CPU-importable and without a CPU fallback on CUDA."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brats2019_tpu.configs import presets as jax_presets
from brats2019_tpu.models.unet3d import UNet3D as JaxUNet3D
from brats2019_tpu.models.unet3d import UNetConfig as JaxUNetConfig
from brats2019_tpu.train.checkpoint import export_params, import_params
from brats2019_tpu_torch.configs import presets
from brats2019_tpu_torch.utils import weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", sorted(jax_presets.PRESETS))
def test_preset_fields_match_reference(name):
    ref = dataclasses.asdict(jax_presets.PRESETS[name])
    got = dataclasses.asdict(presets.get_preset(name))
    assert got == ref


def test_preset_names_and_defaults_match_reference():
    assert sorted(presets.PRESETS) == sorted(jax_presets.PRESETS)
    assert dataclasses.asdict(presets.ExperimentConfig()) == dataclasses.asdict(
        jax_presets.ExperimentConfig()
    )
    with pytest.raises(KeyError):
        presets.get_preset("nope")


@pytest.mark.parametrize("name", ["cascade", "unit", "reference_parity"])
def test_unet_config_methods_match_reference(name):
    exp, ref = presets.get_preset(name), jax_presets.get_preset(name)
    for got, want in ((exp.unet, ref.unet), (exp.coarse_unet, ref.coarse_unet)):
        if want is None:
            assert got is None
            continue
        assert got.min_spatial == want.min_spatial
        assert [got.feats(l) for l in range(6)] == [want.feats(l) for l in range(6)]
        assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                             else torch.float32)


def _jax_params(cfg_kwargs, seed=0, shape=(1, 16, 16, 16, 4)):
    model = JaxUNet3D(JaxUNetConfig(**cfg_kwargs))
    return model.init(jax.random.PRNGKey(seed), jnp.zeros(shape))


@pytest.mark.parametrize("stem", [1, 2])
def test_weight_bridge_roundtrip_is_exact(tmp_path, stem):
    kw = dict(levels=3, base_features=4, max_features=8, stem_downsample=stem)
    params = _jax_params(kw)
    path = str(tmp_path / "params.npz")
    export_params(path, params)
    flat = weights.load_params_npz(path)
    model = weights.build_unet(presets.UNetConfig(**kw), path)
    back = weights.flat_from_state_dict(model.state_dict())
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_init_params_seeded_and_shaped_like_flax(tmp_path):
    kw = dict(levels=3, base_features=8, max_features=16, stem_downsample=2)
    a = weights.init_params(presets.UNetConfig(**kw), seed=3)
    b = weights.init_params(presets.UNetConfig(**kw), seed=3)
    c = weights.init_params(presets.UNetConfig(**kw), seed=4)
    flat_ref = {
        "/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(leaf)
        for kp, leaf in jax.tree_util.tree_flatten_with_path(_jax_params(kw))[0]
    }
    assert sorted(a) == sorted(flat_ref)
    for k in a:
        assert a[k].shape == flat_ref[k].shape and a[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])
        if k.endswith("in_scale"):
            assert (a[k] == 1).all()
        elif k.endswith("bias"):
            assert (a[k] == 0).all()
        else:
            fan_in = int(np.prod(a[k].shape[:-1]))
            std = np.sqrt(1.0 / fan_in)
            assert abs(a[k].std() / std - 1) < 0.25, k
            assert np.abs(a[k]).max() <= 2 * std / 0.87962566103423978 + 1e-6
            assert not np.array_equal(a[k], c[k])
    # the JAX package reads what the port writes
    path = str(tmp_path / "p.npz")
    weights.save_params_npz(path, a)
    got = import_params(path, _jax_params(kw))
    np.testing.assert_array_equal(
        np.asarray(got["params"]["head"]["kernel"]), a["params/head/kernel"]
    )


def test_bridge_rejects_foreign_and_missing_keys():
    kw = dict(levels=2, base_features=4, max_features=8)
    flat = weights.init_params(presets.UNetConfig(**kw))
    with pytest.raises(KeyError):
        weights.state_dict_from_flat({"opt/mu": np.zeros(1)})
    flat.pop("params/head/bias")
    with pytest.raises(RuntimeError):
        weights.build_unet(presets.UNetConfig(**kw), flat)


def _run(code, env=None):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=env,
    )


def test_port_runtime_imports_no_jax():
    res = _run(
        "import sys\n"
        "import brats2019_tpu_torch.cli.predict, brats2019_tpu_torch.infer.predictor\n"
        "import brats2019_tpu_torch.cli.common, brats2019_tpu_torch.models.cascade\n"
        "import brats2019_tpu_torch.cli.train, brats2019_tpu_torch.train.loop\n"
        "import brats2019_tpu_torch.train.step, brats2019_tpu_torch.train.checkpoint\n"
        "import brats2019_tpu_torch.train.loss, brats2019_tpu_torch.train.metrics\n"
        "import brats2019_tpu_torch.data.pipeline, brats2019_tpu_torch.data.sampling\n"
        "import brats2019_tpu_torch.data.augment, brats2019_tpu_torch.utils.flops\n"
        "import brats2019_tpu_torch.utils.logging\n"
        "import brats2019_tpu_torch.cli.import_torch, brats2019_tpu_torch.cli.info\n"
        "import brats2019_tpu_torch.train.distill, brats2019_tpu_torch.utils.profile\n"
        "import brats2019_tpu_torch.utils.torch_import\n"
        "import brats2019_tpu_torch.cli.serve, brats2019_tpu_torch.cli.http_api\n"
        "import brats2019_tpu_torch.infer.payload_cache, brats2019_tpu_torch.infer.tiling\n"
        "import brats2019_tpu_torch.ops.winograd\n"
        "import brats2019_tpu_torch.ops.connected_components\n"
        "import brats2019_tpu_torch.cli.export, brats2019_tpu_torch.cli.evaluate\n"
        "import brats2019_tpu_torch.utils.nifti_fast, brats2019_tpu_torch.infer.ensemble\n"
        "import brats2019_tpu_torch.parallel.mesh, brats2019_tpu_torch.parallel.spatial\n"
        "import brats2019_tpu_torch.parallel.spatial_unet\n"
        "import brats2019_tpu_torch.parallel.multiprocess\n"
        "import brats2019_tpu_torch.infer.multichip\n"
        "import brats2019_tpu_torch.infer.export_hlo, brats2019_tpu_torch.ops.library\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ml_dtypes', 'safetensors',"
        " 'brats2019_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def test_kernel_modules_import_without_triton_or_nvcc():
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    res = _run(
        "import sys\n"
        "sys.modules['triton'] = None  # any import of triton now fails\n"
        "import torch\n"
        "from brats2019_tpu_torch import ops\n"
        "from brats2019_tpu_torch.ops import conv, norm, resize, winograd, _build\n"
        "x = torch.randn(1, 4, 4, 4, 8, requires_grad=True)\n"
        "y = ops.conv3d(x, torch.randn(3, 3, 3, 8, 8))\n"
        "y = ops.instance_norm_act(y, None, None)\n"
        "ops.upsample2x(ops.downsample2x(y)).sum().backward()\n"
        "assert sys.modules['triton'] is None\n"
        "try:\n"
        "    _build.find_nvcc()\n"
        "except RuntimeError:\n"
        "    print('ok')\n",
        env=env,
    )
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def test_cuda_predictor_raises_on_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from brats2019_tpu_torch.infer.predictor import Predictor

    exp = presets.get_preset("cascade")
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor(exp, {}, {}, device="cuda")


def test_wrappers_take_plain_path_on_cpu_and_raise_elsewhere():
    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.ops import conv, norm, resize

    ops.reset_launch_counts()
    x = torch.randn(1, 4, 4, 4, 8)
    w = torch.randn(3, 3, 3, 8, 4)
    torch.testing.assert_close(ops.conv3d(x, w), conv.conv3d_plain(x, w),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.instance_norm_act(x),
                               norm.instance_norm_act_plain(x, None, None),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.downsample2x(x), resize.downsample2x_plain(x),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.upsample2x(x), resize.upsample2x_plain(x),
                               rtol=0, atol=0)
    # the counters count kernel launches only
    assert ops.launch_counts() == dict.fromkeys(ops.KERNEL_WRAPPERS, 0)
    m = torch.empty(1, 4, 4, 4, 8, device="meta")
    for fn, args in ((ops.conv3d, (m, w.to("meta"))),
                     (ops.instance_norm_act, (m,)),
                     (ops.downsample2x, (m,)), (ops.upsample2x, (m,))):
        with pytest.raises(RuntimeError, match="no kernel"):
            fn(*args)
