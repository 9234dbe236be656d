"""The port's ("data", "space") mesh (tmdiff_tpu_torch/parallel/) on the CPU:
worlds of 2 and 4 gloo ranks spawned by parallel/dryrun.py over a FileStore,
one torch thread a rank, each running tests/torch_mesh_workers.py (torch and
the port only). The halo exchange forward and backward, each conv entry in
both lowerings on space shards, the placement rule against the JAX
package's `batch_sharding`, the backend rule, and Pansharpener.sample on
meshes (1, 2), (2, 1) and (2, 2) against the single-process port and
against the JAX Pansharpener on an 8-device (4, 2) mesh, on from_flax
weights with x_T injected. Widths (4, 8, 8, 16), 16x16, batch 8, as
tests/test_sharded_sampling.py. Tolerances are stated at each check."""
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from tmdiff_tpu.models import WavBEST as JaxWavBEST
from tmdiff_tpu.parallel import make_mesh as jax_make_mesh
from tmdiff_tpu.parallel.mesh import batch_sharding
from tmdiff_tpu.pipeline import Pansharpener as JaxPansharpener
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.parallel import mesh as mesh_lib
from tmdiff_tpu_torch.parallel.dryrun import run_world
from tmdiff_tpu_torch.pipeline import Pansharpener
from tmdiff_tpu_torch.utils.weights import from_flax
from flax_params import random_flax_params

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
CHANNELS = (4, 8, 8, 16)
N_TIMESTEP = 10
# the sampling bar of tests/test_pipeline_golden.py
SAMPLE_ATOL = 2e-3
# a meshed image against the single-process port, of the image's scale:
# the same arithmetic on row and batch slices (measured 0)
MESH_RTOL = 1e-5
# a conv on space shards against the same call unsharded, of its scale
CONV_RTOL = 1e-6
SAMPLE_MESHES = ((1, 2), (2, 1), (2, 2))


def _request(b=8, bands=4, size=16, seed=0):
    rng = np.random.default_rng(seed)
    ms = rng.uniform(0.1, 0.9, (b, bands, size, size)).astype(np.float32)
    pan = (ms.mean(1, keepdims=True) + 0.05 * rng.standard_normal((b, 1, size, size)))
    return {"PAN": pan.astype(np.float32), "MS": ms}, rng.standard_normal(ms.shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def carried():
    jmodel = JaxWavBEST(channels=CHANNELS)
    params = random_flax_params(jmodel, seed=7)
    port = from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, params))
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    batch, x_T = _request()
    # JAX's regression method draws x_T from the seed's key whatever x_init says
    x_reg = np.array(jax.random.normal(jax.random.fold_in(jax.random.key(0), 3), x_T.shape))
    cases = (
        ("dpm++", dict(method="dpm++", steps=4, x_init=x_T)),
        ("regression", dict(method="regression", x_init=x_reg)),
        ("ddim_cached", dict(method="ddim_cached", steps=4, refresh_every=2, x_init=x_T)),
        # x_T at 4 sigma: the 0.995 quantile of |x0| passes 1, so the
        # dynamic thresholding clamps (3.6 at every step, measured)
        ("dpm++_thresholding", dict(method="dpm++", steps=4, x_init=4.0 * x_T)),
    )
    cases = tuple((name, dict(kw, sensor="WV3", seed=3)) for name, kw in cases)
    return jmodel, params, port, state, batch, cases


def _more_cases():
    """Every other method of the facade, drawing its own x_T (and the
    ancestral noise) from the seed: per-sample guidance, frames, a refresh
    mask, and sample_tiled over 16x16 crops of a 32x32 scene (8 crops a
    call)."""
    scene, _ = _request(b=2, size=32, seed=5)
    cases = (
        ("dpm++_noise", dict(method="dpm++_noise", steps=5)),
        ("dpm++_cfg", dict(method="dpm++_cfg", steps=4,
                           guidance=np.linspace(0.5, 3.0, 8).astype(np.float32))),
        ("ancestral", dict(method="ancestral", num_frames=5)),
        ("ddim", dict(method="ddim", steps=5)),
        ("ddim_cached_mask", dict(method="ddim_cached", steps=5, cache_level=3,
                                  refresh_mask=[True, False, True, False, False])),
        ("tiled", dict(method="ddim", steps=3, tiled=True, batch=scene, tile=16, overlap=4,
                       tile_batch=4)),
    )
    return tuple((name, dict(kw, sensor="QB", seed=11)) for name, kw in cases)


def _world(n, tasks):
    return run_world("torch_mesh_workers:run_all", n, (tasks,), sys_path=[TESTS], threads=1,
                     timeout=300)


@pytest.fixture(scope="module")
def worlds(carried):
    """Both worlds, started together in the background:
      * 2 ranks: the exchange, the conv entries and the thresholding on
        (1, 2) and (2, 1), and the sampling cases on both;
      * 4 ranks: the same on (1, 4) and (2, 2), the sampling cases on
        (2, 2), the ragged batch 3 and the adaptive solver."""
    _, _, _, state, batch, cases = carried
    meshes = [(1, 2), (2, 1)]
    tasks2 = [("exchange", (meshes,), {}), ("convs", ([(1, 2)],), {}),
              ("thresholding", (meshes,), {})]
    tasks2 += [("sample", (m, state, batch, cases), {}) for m in meshes]
    small = {k: v[:3] for k, v in batch.items()}
    meshes = [(1, 4), (2, 2)]
    tasks4 = [("exchange", (meshes,), {}), ("convs", (meshes,), {}),
              ("thresholding", (meshes,), {}),
              ("sample", ((2, 2), state, batch, cases), {}),
              ("sample", ((2, 2), state, small,
                          (("ragged", dict(method="regression", sensor="QB", seed=0)),)), {}),
              ("adaptive", ((2, 2), state, {k: v[:4] for k, v in batch.items()},
                            _request()[1][:4]), {}),
              ("sample", ((2, 2), state, batch, _more_cases()), {})]
    with ThreadPoolExecutor(2) as pool:
        yield {2: pool.submit(_world, 2, tasks2), 4: pool.submit(_world, 4, tasks4)}


# the single-process and JAX references are computed while the worlds run
@pytest.fixture(scope="module")
def world2(worlds, single, jax_meshed):
    return worlds[2].result()


@pytest.fixture(scope="module")
def world4(worlds, single, jax_meshed):
    return worlds[4].result()


def _results(world2, world4, mesh):
    """(exchange, convs, thresholding, sample) results of every rank of the
    world that ran `mesh`, in rank order."""
    if mesh in ((1, 2), (2, 1)):
        i = [(1, 2), (2, 1)].index(mesh)
        return [(r[0][i], r[1], r[2], r[3 + i]) for r in world2]
    i = [(1, 4), (2, 2)].index(mesh)
    return [(r[0][i], r[1], r[2], r[3]) for r in world4]


# -- the halo exchange and the conv entries ------------------------------------


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (1, 4), (2, 2)])
def test_exchange_rows_forward_and_backward(world2, world4, mesh):
    """Each rank's padded rows are the zero-padded global tensor's rows
    s*H_l - 1 .. (s+1)*H_l, and its input gradient the sum of the upstream
    gradients of every copy of its rows, exactly; space = 1 returns x
    untouched and sends nothing."""
    data, space = mesh
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 8 * space, 5, 2)).astype(np.float32)
    padded = np.pad(x, ((0, 0), (0, 0), (1, 1), (0, 0), (0, 0)))
    h = 8
    grad = np.zeros_like(padded)
    ranks = [res[0] for res in _results(world2, world4, mesh)]
    for r in ranks:
        b = slice(None) if data == 1 else slice(r["d"] * 4 // data, (r["d"] + 1) * 4 // data)
        if space == 1:
            np.testing.assert_array_equal(r["y"], x[b])
            np.testing.assert_array_equal(r["grad"], r["g"])
            assert r["stats"]["exchanges"] == 0
            continue
        rows = slice(r["s"] * h, r["s"] * h + h + 2)
        np.testing.assert_array_equal(r["y"], padded[b, :, rows])
        grad[b, :, rows] += r["g"]
        # forward and backward: one row to each neighbour, each a call
        assert r["stats"]["exchanges"] == 2
    if space > 1:
        for r in ranks:
            b = slice(None) if data == 1 else slice(r["d"] * 4 // data,
                                                    (r["d"] + 1) * 4 // data)
            np.testing.assert_array_equal(r["grad"],
                                          grad[b, :, 1 + r["s"] * h:1 + (r["s"] + 1) * h])


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("impl", ["banded", "auto"])
@pytest.mark.parametrize("case", ["style_bias", "accumulate", "cat2", "grouped_skip"])
def test_conv_entries_on_space_shards(world2, world4, mesh, impl, case):
    """conv3d with style and bias, with `out` accumulation, conv3d_cat of two
    parts and GroupedSkipConv on the halo-padded shards, gathered, against
    the same call unsharded, to 1e-6 of scale (measured 0)."""
    for res in _results(world2, world4, mesh):
        assert res[1][(*mesh, impl, case)] <= CONV_RTOL


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (1, 4), (2, 2)])
def test_dynamic_thresholding_on_shards(world2, world4, mesh):
    """The per-sample quantile over the sample's values gathered from its
    space group: the unsharded clamp exactly, at a max_val that clamps."""
    for res in _results(world2, world4, mesh):
        assert res[2][mesh] == 0.0


# -- placement and backend rules -----------------------------------------------


def _fake_mesh(data, space, rank):
    return mesh_lib.Mesh(data, space, rank, "gloo", torch.device("cpu"), None, None, None)


@pytest.mark.parametrize("shape", [(8, 4, 16, 16), (3, 4, 16, 16), (8, 4, 15, 16),
                                   (8, 4, 12, 16), (8, 1, 32, 8), (4, 3, 16, 16, 8), (8, 768)])
def test_shard_slices_follow_jax_batch_sharding(shape):
    """The batch and height slices of every rank of a (4, 2) mesh against the
    JAX package's batch_sharding on its 8-device (4, 2) mesh: the same
    slices, the ragged batch and the odd height replicated; the one
    deliberate divergence, a height that 2 divides but 16 does not (12),
    stays replicated in the port."""
    jmesh = jax_make_mesh(data=4, space=2)
    # JAX puts the height of a 4-D array at axis -2, of a 5-D one at -2 too
    # (its W); the port's height is axis 2 of both, so hold 5-D shapes
    # against a JAX array with the port's layout moved to NCHW
    jshape = shape if len(shape) != 5 else (shape[0], shape[1] * shape[4], shape[2], shape[3])
    index = batch_sharding(jmesh, len(jshape), jshape).devices_indices_map(jshape)
    devices = np.asarray(jmesh.devices)
    for d in range(4):
        for s in range(2):
            b, h = mesh_lib.shard_slices(_fake_mesh(4, 2, d * 2 + s), shape)
            jidx = index[devices[d, s]]
            assert range(shape[0])[b] == range(shape[0])[jidx[0]]
            if len(shape) < 3:
                assert h == slice(None)
                continue
            want = range(jshape[2])[jidx[2]]
            if shape[2] == 12:
                assert len(want) == 6 and h == slice(None)
            else:
                assert range(shape[2])[h] == want


def test_backend_rule(monkeypatch):
    """CPU ranks take gloo; CUDA ranks take NCCL with a card each; CUDA ranks
    that share a card raise unless gloo is asked for by name."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert mesh_lib.choose_backend("cpu") == ("gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="gloo"):
        mesh_lib.choose_backend("cpu", "nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="share 1 CUDA device"):
        mesh_lib.choose_backend(None)
    with pytest.raises(ValueError, match="share 1 CUDA device"):
        mesh_lib.choose_backend("cuda", "nccl")
    assert mesh_lib.choose_backend("cuda", "gloo") == ("gloo", torch.device("cuda", 0))
    assert mesh_lib.choose_backend("cuda:0", "gloo") == ("gloo", torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh_lib.choose_backend("cuda") == ("nccl", torch.device("cuda", 2))
    mesh = _fake_mesh(2, 2, 3)
    assert "backend=gloo" in repr(mesh) and "transport=gloo" in repr(mesh)


# -- sampling ------------------------------------------------------------------


@pytest.fixture(scope="module")
def single(carried):
    """Every case through the single-process port."""
    _, _, port, _, batch, cases = carried
    sharp = Pansharpener(port, n_timestep=N_TIMESTEP, device="cpu")
    return {name: sharp.sample(batch, **kw) for name, kw in cases}


@pytest.fixture(scope="module")
def jax_meshed(carried):
    """Every case through the JAX Pansharpener on an 8-device (4, 2) mesh;
    ddim_cached through its single-device twin (see the test below)."""
    jmodel, params, _, _, batch, cases = carried
    meshed = JaxPansharpener(jmodel, params, n_timestep=N_TIMESTEP,
                             mesh=jax_make_mesh(data=4, space=2))
    single = JaxPansharpener(jmodel, params, n_timestep=N_TIMESTEP)
    return {name: np.asarray((single if name == "ddim_cached" else meshed).sample(batch, **kw))
            for name, kw in cases}


CASE_NAMES = ("dpm++", "regression", "ddim_cached", "dpm++_thresholding")


@pytest.mark.parametrize("mesh", SAMPLE_MESHES)
@pytest.mark.parametrize("case", CASE_NAMES)
def test_meshed_sampling_matches_single_process(world2, world4, single, mesh, case):
    """Every rank returns the whole image, within 1e-5 of its scale of the
    single-process port's."""
    for res in _results(world2, world4, mesh):
        images, stats, _ = res[3]
        got, want = images[case], single[case]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= MESH_RTOL * np.abs(want).max()
        # halo exchanges happen exactly where the height is split
        assert (stats[case]["exchanges"] > 0) == (mesh[1] > 1)


@pytest.mark.parametrize("case", CASE_NAMES)
def test_meshed_sampling_matches_jax_mesh(world4, jax_meshed, case):
    """The port on a (2, 2) mesh against the JAX Pansharpener on its (4, 2)
    mesh, on the same weights and x_T: the sampling bar. ddim_cached is held
    against the JAX Pansharpener without a mesh: at this size the JAX
    package's meshed ddim_cached differs from its own single-device image
    by 0.051 (a fault of the reference, ROADMAP.md queue 3), where the
    port's meshed image equals the single-process one."""
    images, _, rep = world4[0][3]
    assert "backend=gloo" in rep
    np.testing.assert_allclose(images[case], jax_meshed[case], atol=SAMPLE_ATOL)


def test_meshed_sampling_ragged_batch_falls_back(world4, carried):
    """Batch 3 does not divide the data axis: the batch is replicated (the
    height stays split) and the image is the single-process one."""
    _, _, port, _, batch, _ = carried
    small = {k: v[:3] for k, v in batch.items()}
    want = Pansharpener(port, n_timestep=N_TIMESTEP, device="cpu").sample(
        small, method="regression", sensor="QB", seed=0)
    for res in world4:
        images, stats, _ = res[4]
        assert images["ragged"].shape == small["MS"].shape
        assert np.isfinite(images["ragged"]).all()
        assert np.abs(images["ragged"] - want).max() <= MESH_RTOL * np.abs(want).max()
        assert stats["ragged"]["exchanges"] > 0


def test_adaptive_solver_takes_the_single_process_steps(world4, carried):
    """sample_adaptive on a (2, 2) mesh: the error norm reduced over space,
    then data, gives every rank the single-process accept/reject decisions:
    the same step counts, and the result within 1e-5 of its scale."""
    from torch_mesh_workers import adaptive

    _, _, _, state, batch, _ = carried
    x_T = _request()[1][:4]
    want, want_stats = adaptive(None, state, {k: v[:4] for k, v in batch.items()}, x_T)
    for res in world4:
        got, stats = res[5]
        assert stats == want_stats
        assert np.abs(got - want).max() <= MESH_RTOL * np.abs(want).max()


@pytest.mark.parametrize("case", [name for name, _ in _more_cases()])
def test_every_other_method_on_a_mesh(world4, carried, case):
    """The facade's other methods on (2, 2), each drawing x_T and any
    step noise at the global shape from its seed, against the
    single-process port: within 1e-5 of the image's scale (and the
    ancestral frames with it)."""
    _, _, port, _, batch, _ = carried
    kw = dict(dict(_more_cases())[case])
    sharp = Pansharpener(port, n_timestep=N_TIMESTEP, device="cpu")
    run = sharp.sample_tiled if kw.pop("tiled", False) else sharp.sample
    want = run(kw.pop("batch", batch), **kw)
    for res in world4:
        got = res[6][0][case]
        for g, w in zip(got if case == "ancestral" else (got,),
                        want if case == "ancestral" else (want,)):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= MESH_RTOL * np.abs(w).max()
