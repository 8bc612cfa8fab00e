"""The port's pointnet2 primitives (``com_tpu_torch/ops/pointnet2.py``)
against ``com_tpu/ops/pointnet2.py`` on the CPU, each JAX function vmapped
over the scenes as the JAX models call it: seeded scenes of 2,000 points
with a tenth masked, queries inside, near and far from them (empty balls,
balls with fewer hits than ``nsample``, full balls).  Indices and masks
exactly, features to 1e-5; ``ball_query`` and the groupings bitwise the
same whatever the block of query rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from com_tpu.ops import pointnet2 as jpn2
from com_tpu_torch.ops import pointnet2 as pn2

torch.set_num_threads(2)
B, N, S, C = 2, 2000, 300, 6


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(7)
    xyz = rng.uniform(-6, 6, (B, N, 3)).astype(np.float32)
    xyz[:, :200] = rng.normal(0, 0.3, (B, 200, 3))  # a dense clump: full balls
    valid = rng.rand(B, N) > 0.1
    q = np.concatenate([rng.uniform(-6, 6, (B, S - 20, 3)),  # sparse: few hits
                        rng.uniform(40, 50, (B, 10, 3)),  # far: empty balls
                        rng.normal(0, 0.2, (B, 10, 3))], axis=1).astype(np.float32)
    q[:, -10:] = xyz[:, :10]  # on masked points too
    valid[:, :5] = False
    feats = rng.rand(B, N, C).astype(np.float32)
    return xyz, valid, q, feats


def jv(fn, *args):
    """``fn`` vmapped over the scenes of numpy ``args``, as numpy."""
    out = jax.vmap(fn)(*(jnp.asarray(a) for a in args))
    return jax.tree_util.tree_map(np.asarray, out)


def tt(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def test_square_distance_matches_jax(scene):
    xyz, _, q, _ = scene
    got = pn2.square_distance(*tt(q, xyz)).numpy()
    np.testing.assert_array_equal(got, jv(jpn2.square_distance, q, xyz))


@pytest.mark.parametrize("num", [1, 64, 300])
def test_farthest_point_sample_matches_jax(scene, num):
    """The same indices; none invalid; a scene whose valid points are fewer
    than the samples repeats, as JAX's, and one with none gives index 0."""
    xyz, valid, _, _ = scene
    valid = valid.copy()
    valid[1, 150:] = False  # 145 valid points in scene 1
    got = pn2.farthest_point_sample(*tt(xyz, valid), num).numpy()
    want = jv(lambda x, v: jpn2.farthest_point_sample(x, v, num), xyz, valid)
    np.testing.assert_array_equal(got, want)
    assert valid[0][got[0]].all()
    none = pn2.farthest_point_sample(*tt(xyz[:1], np.zeros((1, N), bool)), 4)
    np.testing.assert_array_equal(none.numpy(), np.asarray(jpn2.farthest_point_sample(
        jnp.asarray(xyz[0]), jnp.zeros(N, bool), 4))[None])


@pytest.mark.parametrize("radius,nsample", [(0.3, 16), (1.0, 8), (2.5, 32)])
def test_ball_query_matches_jax(scene, radius, nsample):
    """Indices, empty balls and real-hit slots exactly; the cases of this
    scene all present (empty, short, full)."""
    xyz, valid, q, _ = scene
    idx, empty, slot = pn2.ball_query(radius, nsample, *tt(xyz, q, valid))
    want = jv(lambda x, c, v: jpn2.ball_query(radius, nsample, x, c, v), xyz, q, valid)
    for got, w, name in zip((idx, empty, slot), want, ("idx", "empty", "slot_valid")):
        np.testing.assert_array_equal(got.numpy(), w, err_msg=name)
    hits = slot.numpy().sum(-1)
    assert empty.any() and ((hits > 0) & (hits < nsample)).any() and (hits == nsample).any()
    assert valid[np.arange(B)[:, None, None], idx.numpy()][slot.numpy()].all()


@pytest.mark.parametrize("block", [1, 5000, 1 << 30])
def test_ball_query_blocks_are_bitwise_equal(scene, block):
    """One query row a block, a few rows, and all rows in one block."""
    xyz, valid, q, feats = scene
    ref = pn2.query_and_group(1.0, 16, *tt(xyz, q, feats, valid))
    got = pn2.query_and_group(1.0, 16, *tt(xyz, q, feats, valid), block=block)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_xyz", [True, False])
def test_query_and_group_matches_jax(scene, use_xyz):
    xyz, valid, q, feats = scene
    got = pn2.query_and_group(0.8, 16, *tt(xyz, q, feats, valid), use_xyz=use_xyz)
    want = jv(lambda x, c, f, v: jpn2.query_and_group(0.8, 16, x, c, f, v, use_xyz=use_xyz),
              xyz, q, feats, valid)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-5, atol=1e-5)
    for a, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), w)
    assert got[0].shape == (B, S, 16, (3 if use_xyz else 0) + C)
    assert (got[0].numpy()[got[2].numpy()] == 0).all()  # empty groups zeroed


def test_group_and_gather_points_match_jax(scene):
    xyz, valid, q, feats = scene
    idx = pn2.ball_query(1.0, 8, *tt(xyz, q, valid))[0]
    np.testing.assert_array_equal(pn2.group_points(torch.from_numpy(feats), idx).numpy(),
                                  jv(jpn2.group_points, feats, idx.numpy()))
    sel = idx[..., 0]
    np.testing.assert_array_equal(pn2.gather_points(torch.from_numpy(feats), sel).numpy(),
                                  jv(jpn2.gather_points, feats, sel.numpy()))


def test_three_nn_and_interpolate_match_jax(scene):
    """Indices exactly (ties to the lower index: masked known points all at
    the same huge distance in a scene of 2 valid ones), distances and
    interpolated features to 1e-5."""
    xyz, valid, q, feats = scene
    known_valid = valid.copy()
    known_valid[1, 2:] = False
    known_valid[1, :2] = True
    dist, idx = pn2.three_nn(*tt(q, xyz, known_valid))
    jd, ji = jv(jpn2.three_nn, q, xyz, known_valid)
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_allclose(dist.numpy(), jd, rtol=1e-5, atol=1e-5)
    got = pn2.three_interpolate(torch.from_numpy(feats), idx, dist).numpy()
    np.testing.assert_allclose(got, jv(jpn2.three_interpolate, feats, ji, jd), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("sectors,num", [(6, 128), (4, 101)])
def test_sector_fps_matches_jax(scene, sectors, num):
    """Each sector's share (the first takes the remainder) and the empty
    sectors' invalid slots: every point of scene 1 in one half-plane."""
    xyz, valid, _, _ = scene
    xyz = xyz.copy()
    xyz[1, :, 1] = np.abs(xyz[1, :, 1]) + 0.1
    idx, ok = pn2.sector_fps(*tt(xyz, valid), num, sectors)
    want_idx, want_ok = jv(lambda x, v: jpn2.sector_fps(x, v, num, sectors), xyz, valid)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    assert ok[0].all() and not ok[1].all()


def test_sample_points_with_roi_matches_jax(scene):
    xyz, valid, _, _ = scene
    rng = np.random.RandomState(3)
    rois = np.concatenate([rng.uniform(-5, 5, (B, 12, 3)), rng.uniform(1, 4, (B, 12, 3)),
                           rng.uniform(-3, 3, (B, 12, 1))], -1).astype(np.float32)
    roi_valid = rng.rand(B, 12) > 0.3
    got = pn2.sample_points_with_roi(*tt(rois, roi_valid, xyz, valid), 1.6).numpy()
    want = jv(lambda r, rv, x, v: jpn2.sample_points_with_roi(r, rv, x, v, 1.6),
              rois, roi_valid, xyz, valid)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize("aggregation", ["voxel_avg_pool", "local_interpolation"])
@pytest.mark.parametrize("block", [1 << 30, 20000])
def test_vector_pool_features_match_jax(scene, aggregation, block):
    """Sub-voxel means or 3-NN interpolation at the sub-voxel centres,
    empty queries zeroed; the same in blocks of query rows."""
    xyz, valid, q, feats = scene
    got, empty = pn2.vector_pool_features(*tt(xyz, feats, valid, q), (3, 2, 2), 0.8, 16,
                                          aggregation, block=block)
    want, want_empty = jv(lambda x, f, v, c: jpn2.vector_pool_features(
        x, f, v, c, (3, 2, 2), 0.8, 16, aggregation), xyz, feats, valid, q)
    np.testing.assert_array_equal(empty.numpy(), want_empty)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert got.shape == (B, S, 12 * (3 + C)) and empty.any() and not empty.all()


def test_vector_pool_gradient_matches_jax(scene):
    """The features' gradient through the local interpolation."""
    xyz, valid, q, feats = scene
    w = np.random.RandomState(5).rand(B, S, 8 * (3 + C)).astype(np.float32)

    def jloss(f):
        out = jax.vmap(lambda x, f1, v, c: jpn2.vector_pool_features(
            x, f1, v, c, (2, 2, 2), 1.0, 8)[0])(jnp.asarray(xyz), f, jnp.asarray(valid),
                                                jnp.asarray(q))
        return (out * w).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(feats)))
    f = torch.from_numpy(feats.copy()).requires_grad_(True)
    out = pn2.vector_pool_features(*tt(xyz), f, *tt(valid, q), (2, 2, 2), 1.0, 8)[0]
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), want, rtol=1e-5, atol=1e-5)
