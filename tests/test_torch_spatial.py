"""PyTorch port: the spatial pieces of the mesh (``parallel/mesh.py``,
``parallel/spatial.py``, ``parallel/spatial_unet.py``) against the JAX
package's on its 8-virtual-device CPU mesh, on the same seeded inputs and
bridged weights, with the port at 2 and 4 CPU shards:

* the sharded conv: bitwise the port's unsharded conv in f32, within 1e-5 of
  the reference's;
* the halo exchange: zeros or the replicated edge plane at the volume's edges;
* the spatial forward within 1e-4 of the reference's and of the unsharded
  forward; the spatial training gradients within 1e-4 of the reference's;
* the tile sweep's probabilities within 1e-4 of the reference's; the
  cascade sweep and ensemble: probabilities within 1e-4 of the port's
  single-device programs (which ``tests/test_torch_ensemble.py`` holds to
  the JAX package's), labels and start equal to the reference's mesh
  programs' except on ties.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brats2019_tpu.models.unet3d import UNet3D as JaxUNet3D
from brats2019_tpu.models.unet3d import UNetConfig as JaxUNetConfig
from brats2019_tpu.parallel import mesh as ref_mesh
from brats2019_tpu.parallel import spatial as ref_spatial
from brats2019_tpu.parallel import spatial_unet as ref_sunet
from brats2019_tpu.train.checkpoint import export_params
from brats2019_tpu_torch.configs.presets import InferenceConfig, UNetConfig
from brats2019_tpu_torch.models.unet3d import UNet3D
from brats2019_tpu_torch.ops import conv3d
from brats2019_tpu_torch.parallel import mesh, spatial, spatial_unet
from brats2019_tpu_torch.utils.weights import load_params, state_dict_from_flat

SHARDS = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_env():
    return ref_mesh.make_mesh()


def _bridge(tmp_path_factory, jcfg_kw, seed, x_shape):
    """JAX params of a config and the port model with the same weights."""
    jcfg = JaxUNetConfig(**jcfg_kw)
    params = JaxUNet3D(jcfg).init(jax.random.PRNGKey(seed),
                                  jnp.zeros((1,) + tuple(x_shape)))
    path = str(tmp_path_factory.mktemp("bridge") / "p.npz")
    export_params(path, params)
    model = UNet3D(UNetConfig(**jcfg_kw))
    model.load_state_dict(state_dict_from_flat(load_params(path)))
    return params, model


def test_mesh_shards_and_collectives():
    env = mesh.make_mesh(["cpu"] * 3)
    assert (env.n_local, env.n_data, env.rank, env.world) == (3, 3, 0, 1)
    assert [env.shard_index(j) for j in range(3)] == [0, 1, 2]
    assert env.local_devices() == [torch.device("cpu")]
    ts = [torch.full((2,), float(j + 1)) for j in range(3)]
    assert mesh.psum(env, ts).tolist() == [6.0, 6.0]
    assert mesh.pmean(env, ts).tolist() == [2.0, 2.0]
    assert [t.tolist() for t in mesh.gather_shards(env, ts)] == [t.tolist() for t in ts]
    assert mesh.all_gather_objects(env, {"a": 1}) == [{"a": 1}]
    with pytest.raises(ValueError):
        mesh.psum(env, ts[:2])
    assert mesh.initialize_distributed() is False     # no world declared


@pytest.mark.parametrize("edge", ["zeros", "replicate"])
def test_halo_exchange_edges(edge):
    env = mesh.make_mesh(["cpu"] * 4)
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    padded = spatial.halo_exchange(env, spatial.split_x(env, x), 1, edge=edge)
    full = torch.cat([x[:1] * (edge == "replicate"), x,
                      x[-1:] * (edge == "replicate")])
    for j, p in enumerate(padded):
        assert torch.equal(p, full[2 * j:2 * j + 4])


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_conv_is_bitwise_the_unsharded_and_matches_the_reference(ref_env, n):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 8, 8, 3)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 3, 5)) * 0.2).astype(np.float32)
    env = mesh.make_mesh(["cpu"] * n)
    got = spatial.make_sharded_conv3d(env)(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(got, conv3d(torch.from_numpy(x)[None], torch.from_numpy(w))[0])
    ref = np.asarray(ref_spatial.make_sharded_conv3d(ref_env)(jnp.asarray(x),
                                                            jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


SUNET = {
    "plain-l2": dict(levels=2, base_features=4, compute_dtype="float32"),
    "s2d-l2": dict(levels=2, base_features=4, compute_dtype="float32",
                   stem_downsample=2),
    "leaky-l3": dict(levels=3, base_features=4, max_features=8,
                     compute_dtype="float32", activation="leaky_relu"),
}


@pytest.fixture(scope="module", params=sorted(SUNET))
def sunet(request, tmp_path_factory, ref_env):
    """(config kw, port model, input, labels, the reference's forward and
    training gradients), the JAX side computed once a config."""
    kw = SUNET[request.param]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 16, 12, 4)).astype(np.float32)
    y = rng.integers(0, 4, (64, 16, 12)).astype(np.int32)
    params, model = _bridge(tmp_path_factory, kw, 1, x.shape)
    jcfg = JaxUNetConfig(**kw)
    ref_fwd = np.asarray(ref_sunet.make_spatial_unet(ref_env, jcfg)(params, jnp.asarray(x)))
    loss, grads = ref_sunet.make_spatial_train_grad(ref_env, jcfg)(
        params, jnp.asarray(x), jnp.asarray(y))
    path = str(tmp_path_factory.mktemp("grads") / "g.npz")
    export_params(path, grads)
    return kw, model, x, y, ref_fwd, float(loss), load_params(path)


@pytest.mark.parametrize("n", SHARDS)
def test_spatial_forward_matches_the_reference(sunet, n):
    kw, model, x, _, ref_fwd, _, _ = sunet
    env = mesh.make_mesh(["cpu"] * n)
    got = spatial_unet.make_spatial_unet(env, model)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref_fwd, atol=1e-4)
    with torch.no_grad():
        whole = model(torch.from_numpy(x)[None])[0]
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-4)


@pytest.mark.parametrize("n", SHARDS)
def test_spatial_train_grads_match_the_reference(sunet, n):
    kw, model, x, y, _, ref_loss, ref_grads = sunet
    env = mesh.make_mesh(["cpu"] * n)
    loss, grads = spatial_unet.make_spatial_train_grad(env, model)(
        torch.from_numpy(x), torch.from_numpy(y).long())
    assert abs(float(loss) - ref_loss) <= 1e-4 * max(1.0, abs(ref_loss))
    assert len(grads) == len(ref_grads)
    for name, g in grads.items():
        want = ref_grads["params/" + name.replace(".", "/")]
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want, atol=1e-4 * scale, err_msg=name)


def test_spatial_extent_must_divide():
    model = UNet3D(UNetConfig(levels=2, base_features=4, compute_dtype="float32"))
    fn = spatial_unet.make_spatial_unet(mesh.make_mesh(["cpu"] * 4), model)
    with pytest.raises(ValueError, match="divisible"):
        fn(torch.zeros(20, 8, 8, 4))     # 20 % (2 * 4) != 0


def test_stripe_items_is_the_reference():
    o = np.array([[0, 0, 0], [8, 0, 0], [0, 8, 4]], np.int32)
    for n_flips, n_dev in ((1, 2), (8, 4), (8, 3), (1, 8)):
        got = spatial._stripe_items(o, n_flips, n_dev)
        want = ref_spatial._stripe_items(o, n_flips, n_dev)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def sweep_case(tmp_path_factory, ref_env):
    """A stem-1 f32 net, a (24, 20, 16) volume and the reference's tile
    sweep with 8 flips and with 1."""
    from brats2019_tpu.infer.tiling import blend_weight, tile_origins

    kw = dict(levels=2, base_features=4, compute_dtype="float32")
    rng = np.random.default_rng(2)
    vol = rng.standard_normal((24, 20, 16, 4)).astype(np.float32)
    params, model = _bridge(tmp_path_factory, kw, 2, (16, 16, 16, 4))
    tile = (16, 16, 16)
    origins = np.asarray(tile_origins((24, 20, 16), tile, 0.5))
    weight = np.asarray(blend_weight(tile, "gaussian", 0.125))
    jmodel = JaxUNet3D(JaxUNetConfig(**kw))
    fn = lambda prm, p: jax.nn.softmax(jmodel.apply(prm, p[None])[0], -1)
    refs = {}
    for n_flips in (1, 8):
        run = ref_spatial.distributed_tile_sweep(
            fn, ref_env, vol.shape[:3], origins, tile, weight, 4,
            n_flips=n_flips, params=params)
        refs[n_flips] = np.asarray(run(jnp.asarray(vol)))
    return model, vol, origins, tile, weight, refs


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("n_flips", [1, 8])
def test_tile_sweep_matches_the_reference(sweep_case, n, n_flips):
    model, vol, origins, tile, weight, refs = sweep_case
    env = mesh.make_mesh(["cpu"] * n)
    fn = lambda p: torch.softmax(model(p[None])[0].float(), -1)
    run = spatial.distributed_tile_sweep(fn, env, vol.shape[:3], origins, tile,
                                         weight, 4, n_flips=n_flips)
    with torch.no_grad():
        got = run(torch.from_numpy(vol)).numpy()
    np.testing.assert_allclose(got, refs[n_flips], atol=1e-4)


CASC_FINE = dict(levels=2, base_features=4, max_features=8, stem_downsample=2,
                 compute_dtype="float32")
CASC_COARSE = dict(levels=2, base_features=4, max_features=8,
                   compute_dtype="float32")
CASC_INFER = dict(canvas=(32, 32, 32), tile=(16, 16, 16), cascade=True,
                  tta_flips=True, roi_shape=(16, 16, 16),
                  coarse_shape=(16, 16, 16), min_component_voxels=0,
                  et_min_voxels=0, compute_dtype="float32",
                  tta_precision="float32")


def _top2_gap(p):
    s = np.sort(p, axis=-1)
    return s[..., -1] - s[..., -2]


@pytest.fixture(scope="module")
def cascade_members(tmp_path_factory, ref_env):
    """Two (fine, coarse) members bridged from JAX params, a volume, and the
    JAX package's mesh cascade labels of member 0 and of the ensemble."""
    from brats2019_tpu.configs.presets import InferenceConfig as JaxInfer

    members, jax_members = [], []
    for seed in (3, 5):
        pf, fine = _bridge(tmp_path_factory, CASC_FINE, seed, (16, 16, 16, 4))
        pc, coarse = _bridge(tmp_path_factory, CASC_COARSE, seed + 1, (16, 16, 16, 4))
        members.append((fine, coarse))
        jax_members.append((pf, pc))
    rng = np.random.default_rng(4)
    vol = (rng.standard_normal((32, 32, 32, 4)) * 3 + 1).astype(np.float32)
    jf = JaxUNet3D(JaxUNetConfig(**CASC_FINE))
    jc = JaxUNet3D(JaxUNetConfig(**CASC_COARSE))
    kw = dict(stem=2, fine_lowres_apply=lambda p, x: jf.apply(p, x, subpixel=False))
    apply_f, apply_c = (lambda p, x: jf.apply(p, x)), (lambda p, x: jc.apply(p, x))
    cfg = JaxInfer(**CASC_INFER)
    labels, start = ref_spatial.distributed_cascade_sweep(
        apply_f, apply_c, ref_env, cfg, (32, 32, 32), 4, *jax_members[0], **kw)(
            jnp.asarray(vol))
    ens = ref_spatial.distributed_cascade_ensemble(
        apply_f, apply_c, ref_env, cfg, (32, 32, 32), 4,
        [m[0] for m in jax_members], [m[1] for m in jax_members], **kw)(
            jnp.asarray(vol))
    refs = {"labels": np.asarray(labels), "start": np.asarray(start),
            "ensemble": np.asarray(ens)}
    return members, vol, refs


@pytest.mark.parametrize("n", SHARDS)
def test_cascade_sweep_matches_the_single_device_program(cascade_members, n):
    """The mesh cascade's probabilities and labels against the port's own
    single-device split program (``SplitCascade.probs``), which
    ``tests/test_torch_ensemble.py`` holds to the JAX package's."""
    from brats2019_tpu_torch.models.cascade import SplitCascade, labels_from_blocks

    fine, coarse = cascade_members[0][0]
    vol, refs = cascade_members[1], cascade_members[2]
    cfg = InferenceConfig(**CASC_INFER)
    env = mesh.make_mesh(["cpu"] * n)
    member_sweep, st = spatial._cascade_member_sweep(cfg, (32, 32, 32), 4,
                                                     env.n_data, stem=2)
    image = {torch.device("cpu"): spatial._zscored_on(env, torch.from_numpy(vol))[
        torch.device("cpu")]}
    with torch.no_grad():
        canvas_p, wsum, start = member_sweep(env, image, lambda d: (fine, coarse))
        probs = (canvas_p / torch.clamp(wsum, min=1e-8))
        single = SplitCascade(fine, coarse, cfg, (32, 32, 32))
        ref_probs, ref_start = single.probs(torch.from_numpy(vol))
        labels, lstart = spatial.distributed_cascade_sweep(
            lambda d: (fine, coarse), env, cfg, (32, 32, 32), 4, stem=2)(
                torch.from_numpy(vol))
    from brats2019_tpu_torch.models.cascade import probs_from_blocks

    full = probs_from_blocks(probs, 2).numpy()
    assert torch.equal(start, ref_start) and torch.equal(lstart, ref_start)
    np.testing.assert_allclose(full, ref_probs.numpy(), atol=1e-4)
    ref_labels = ref_probs.argmax(-1).numpy()
    diff = labels.numpy() != ref_labels
    assert (_top2_gap(ref_probs.numpy())[diff] < 1e-5).all()
    # the JAX package's mesh cascade on its 8 devices: the same start, the
    # same labels except on ties
    assert lstart.tolist() == refs["start"].tolist()
    diff = labels.numpy() != refs["labels"]
    assert (_top2_gap(ref_probs.numpy())[diff] < 1e-5).all()


@pytest.mark.parametrize("n", SHARDS)
def test_cascade_ensemble_matches_the_member_mean(cascade_members, n):
    """The mesh ensemble's labels: the argmax of the members' single-device
    probabilities added at their starts, except on ties."""
    from brats2019_tpu_torch.models.cascade import SplitCascade

    members, vol, refs = cascade_members
    cfg = InferenceConfig(**CASC_INFER)
    env = mesh.make_mesh(["cpu"] * n)
    nets = [lambda d, f=f, c=c: (f, c) for f, c in members]
    with torch.no_grad():
        got = spatial.distributed_cascade_ensemble(nets, env, cfg, (32, 32, 32),
                                                   4, stem=2)(torch.from_numpy(vol))
        acc = torch.zeros((32, 32, 32, 4))
        for f, c in members:
            p, s = SplitCascade(f, c, cfg, (32, 32, 32)).probs(torch.from_numpy(vol))
            sx, sy, sz = s.tolist()
            acc[sx:sx + 16, sy:sy + 16, sz:sz + 16] += p
    ref = acc.argmax(-1).numpy()
    diff = got.numpy() != ref
    assert (_top2_gap(acc.numpy())[diff] < 1e-5).all()
    diff = got.numpy() != refs["ensemble"]       # the JAX package's
    assert (_top2_gap(acc.numpy())[diff] < 1e-5).all()
