"""fsnerf_tpu_torch sampling, occupancy grid and volume integration against
fsnerf_tpu: sampling and compaction exact, the grid bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsnerf_tpu.ops import occgrid as jog
from fsnerf_tpu.ops import sampling as jsamp
from fsnerf_tpu.ops import volrend as jvol
from fsnerf_tpu_torch.config import SamplingConfig
from fsnerf_tpu_torch.ops import occgrid as og
from fsnerf_tpu_torch.ops import sampling, volrend
from torch_parity import (AABB, shell_rays, sphere_density_jax,
                          sphere_density_torch, t)


@pytest.mark.parametrize("stratified", [False, True])
def test_uniform_samples_and_compaction_exact(stratified):
    """The lattice, sample points and the spread compaction match exactly.
    The stratified phase is drawn by the JAX key and handed to the port as
    its explicit jitter tensor."""
    ro, rd = shell_rays(48)
    key = jax.random.key(3) if stratified else None
    tj, dj, vj = jsamp.uniform_samples(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(AABB), 64, key=key,
        step_size=0.05)
    jitter = (t(jax.random.uniform(key, (48, 1))) if stratified else None)
    tt, dt, vt = sampling.uniform_samples(t(ro), t(rd), t(AABB), 64,
                                          jitter=jitter, step_size=0.05)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(
        sampling.sample_points(t(ro), t(rd), tt).numpy(),
        np.asarray(jsamp.sample_points(jnp.asarray(ro), jnp.asarray(rd), tj)))

    keep = np.random.default_rng(2).uniform(size=(48, 64)) < 0.6
    mask = np.asarray(vj) & keep
    for k in (16, 48):
        ref = jsamp.compact_samples_uniform(tj, dj[:, 0], jnp.asarray(mask),
                                            k)
        got = sampling.compact_samples_uniform(
            tt, dt[:, 0], torch.as_tensor(mask), k)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("spread", [False, True])
def test_compact_samples_bitwise(spread):
    """compact_samples against the JAX function: seeded masks whose rays
    hold 0, fewer than k, exactly k and more than k valid samples, with
    non-uniform t and deltas."""
    rng = np.random.default_rng(7)
    S, k = 32, 8
    counts = [0, 1, 3, 7, 8, 8, 9, 12, 20, 31, 32, 0]
    mask = np.zeros((len(counts), S), bool)
    for r, n in enumerate(counts):
        mask[r, rng.choice(S, n, replace=False)] = True
    t_mid = np.sort(rng.uniform(2.0, 6.0, (len(counts), S)), -1).astype(
        np.float32)
    deltas = rng.uniform(0.01, 0.2, (len(counts), S)).astype(np.float32)
    ref = jsamp.compact_samples(jnp.asarray(t_mid), jnp.asarray(deltas),
                                jnp.asarray(mask), k, spread=spread)
    got = sampling.compact_samples(t(t_mid), t(deltas), torch.as_tensor(mask),
                                   k, spread=spread)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == torch.as_tensor(
            np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _grids(levels, dilation, res=16):
    jg = jog.create(jnp.asarray(AABB), resolution=res, levels=levels,
                    query_dilation=dilation)
    tg = og.create(AABB, resolution=res, levels=levels,
                   query_dilation=dilation)
    return jg, tg


def _query_points(n=4000, seed=5, scale=3.2):
    rng = np.random.default_rng(seed)
    return rng.uniform(-scale, scale, (n, 3)).astype(np.float32)


def _assert_grid_equal(tg, jg, x):
    np.testing.assert_array_equal(tg.occs.numpy(), np.asarray(jg.occs))
    np.testing.assert_array_equal(tg.binaries.numpy(),
                                  np.asarray(jg.binaries))
    assert tg.thre.item() == float(jg.thre)
    occ_t, od_t = og.query_with_density(tg, t(x))
    occ_j, od_j = jog.query_with_density(jg, jnp.asarray(x))
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    np.testing.assert_array_equal(od_t.numpy(), np.asarray(od_j))
    np.testing.assert_array_equal(og.query(tg, t(x)).numpy(),
                                  np.asarray(jog.query(jg, jnp.asarray(x))))


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("dilation", [0, 1, 2])
def test_occgrid_create_update_query_bitwise(levels, dilation):
    """create, the warmup full update (cell centres), a round-robin partial
    update and query_with_density agree bit for bit, for every dilation
    radius and level count (two float32 tables with the z window applied
    at build time == the packed uint32 table with the window at query
    time)."""
    jg, tg = _grids(levels, dilation)
    x = _query_points()
    _assert_grid_equal(tg, jg, x)
    jg = jog.update(jg, lambda p: sphere_density_jax(p, 1.1, 60.0), None,
                    jnp.asarray(0))
    tg = og.update(tg, lambda p: sphere_density_torch(p, 1.1, 60.0), 0)
    _assert_grid_equal(tg, jg, x)
    # a shifted blob refreshed in the round-robin slice of step 300
    jd = lambda p: sphere_density_jax(p - jnp.asarray([0.5, 0, 0]), 0.7, 9.0)
    td = lambda p: sphere_density_torch(p - t([0.5, 0, 0]), 0.7, 9.0)
    jg = jog.update(jg, jd, None, jnp.asarray(300), hold_steps=0)
    tg = og.update(tg, td, 300)
    _assert_grid_equal(tg, jg, x)


def test_occgrid_hold_and_conservative_bitwise():
    jg, tg = _grids(1, 1)
    jg = jog.update(jg, sphere_density_jax, None, jnp.asarray(5),
                    hold_steps=10)
    tg = og.update(tg, sphere_density_torch, 5, hold_steps=10)
    assert tg.thre.item() == -1.0
    x = _query_points(seed=6, scale=1.6)
    _assert_grid_equal(tg, jg, x)
    _assert_grid_equal(og.conservative(tg), jog.conservative(jg), x)
    # no query tables: occupancy from occs, od estimate 0
    _assert_grid_equal(tg.replace(occ_q=None, od_q=None),
                       jg.replace(occs_q=None), x)


def test_cell_positions_with_jitter_match():
    """The jittered refresh positions agree when both packages are handed
    the same numpy jitter."""
    res = 16
    idx = np.arange(0, res ** 3, 7, dtype=np.int32)
    u = np.random.default_rng(9).uniform(size=(idx.size, 3)).astype(
        np.float32)
    for lv in (0, 1):
        ab_j = jog.level_aabb(jnp.asarray(AABB), lv)
        ab_t = og.level_aabb(t(AABB), lv)
        np.testing.assert_array_equal(ab_t.numpy(), np.asarray(ab_j))
        ref = jog._cell_positions(jnp.asarray(idx), ab_j, res, None,
                                  u=jnp.asarray(u))
        got = og._cell_positions(torch.as_tensor(idx).long(), ab_t, res, t(u))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kw", [{}, dict(query_dilation=0),
                                dict(query_stride=2),
                                dict(grid_resolution=64, n_samples=256)])
def test_resolve_query_plan_matches(kw):
    from fsnerf_tpu.config import SamplingConfig as JSamplingConfig
    assert og.resolve_query_plan(SamplingConfig(**kw), AABB) == \
        jog.resolve_query_plan(JSamplingConfig(**kw), AABB)


def test_volume_render_matches_jax():
    rng = np.random.default_rng(4)
    sig = rng.normal(2.0, 3.0, (32, 40)).astype(np.float32)
    rgb = rng.uniform(size=(32, 40, 3)).astype(np.float32)
    tv = np.sort(rng.uniform(2, 6, (32, 40)), axis=-1).astype(np.float32)
    dl = rng.uniform(0.01, 0.1, (32, 40)).astype(np.float32)
    mask = rng.uniform(size=(32, 40)) < 0.7
    ref = jvol.volume_render(*map(jnp.asarray, (sig, rgb, tv, dl, mask)), 1.0)
    got = volrend.volume_render(t(sig), t(rgb), t(tv), t(dl),
                                torch.as_tensor(mask), 1.0)
    for k in ("rgb", "opacity", "depth", "weights", "trans_final"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6)
