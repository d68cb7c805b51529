"""Shared inputs for the parity tests of fsnerf_tpu_torch against fsnerf_tpu.

Everything is made with numpy from a seed and handed to both packages:
weights as a flax params tree (carried to the port by
utils/interop.py::state_dict_from_jax), rays, jitter and masks as arrays.
Small sizes: NeRF 4x64 with skip (2,), n_freqs 4/2, SiNeRF 4x64, grid res
16, 48 rays.
"""

import numpy as np
import torch

SMALL = dict(n_layers=4, d_filter=64, skip=(2,), n_freqs=4, n_freqs_views=2)
AABB = np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)


def nerf_params_np(seed=0, n_layers=4, d_filter=64, skip=(2,), n_freqs=4,
                   n_freqs_views=2):
    """flax NeRF params {'params': {module: {kernel [in, out], bias}}} with
    torch.nn.Linear's init distribution, from numpy."""
    rng = np.random.default_rng(seed)
    d_enc = 3 * (1 + 2 * n_freqs)
    d_dir = 3 * (1 + 2 * n_freqs_views)

    def dense(fan_in, fan_out):
        b = 1.0 / np.sqrt(fan_in)
        return {"kernel": rng.uniform(-b, b, (fan_in, fan_out))
                .astype(np.float32),
                "bias": rng.uniform(-b, b, (fan_out,)).astype(np.float32)}

    p, fan = {}, d_enc
    for i in range(n_layers):
        p[f"layers_{i}"] = dense(fan, d_filter)
        fan = d_filter + d_enc if i in skip else d_filter
    p["sigma"] = dense(fan, 1)
    p["connection"] = dense(fan, d_filter)
    p["branch"] = dense(d_filter + d_dir, d_filter // 2)
    p["rgb"] = dense(d_filter // 2, 3)
    return {"params": p}


def sinerf_params_np(seed=0, n_layers=4, width=64, use_viewdirs=True):
    """flax SiNeRF params {'params': {module: {kernel [in, out], bias}}}
    with the SIREN init of the sine layers (U(-s, s), s = 1/fan_in first,
    sqrt(6/fan_in) after) and torch.nn.Linear's for the plain ones, from
    numpy."""
    rng = np.random.default_rng(seed)

    def dense(fan_in, fan_out, s=None):
        b = 1.0 / np.sqrt(fan_in) if s is None else s
        return {"kernel": rng.uniform(-b, b, (fan_in, fan_out))
                .astype(np.float32),
                "bias": rng.uniform(-b, b, (fan_out,)).astype(np.float32)}

    p = {"first_0": dense(3, width, 1.0 / 3)}
    for i in range(1, n_layers):
        p[f"first_{i}"] = dense(width, width, np.sqrt(6.0 / width))
    p["sigma_0"] = dense(width, width // 2, np.sqrt(6.0 / width))
    p["sigma_1"] = dense(width // 2, 1)
    p["fc_feature"] = dense(width, width)
    d_r = width + (3 if use_viewdirs else 0)
    p["rgb_0"] = dense(d_r, width // 2, np.sqrt(6.0 / d_r))
    p["rgb_1"] = dense(width // 2, 3)
    return {"params": p}


def shell_rays(n=48, seed=0):
    """Rays from a radius-4 shell aimed roughly at the origin."""
    rng = np.random.default_rng(seed)
    ro = rng.normal(size=(n, 3))
    ro = 4.0 * ro / np.linalg.norm(ro, axis=-1, keepdims=True)
    rd = -ro / 4.0 + 0.1 * rng.normal(size=(n, 3))
    rd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


def sphere_density_torch(x, radius=1.2, value=30.0):
    return torch.where(torch.linalg.norm(x, dim=-1) < radius, value, 0.0)


def sphere_density_jax(x, radius=1.2, value=30.0):
    import jax.numpy as jnp
    return jnp.where(jnp.linalg.norm(x, axis=-1) < radius, value, 0.0)


def t(a):
    """numpy -> float32 CPU tensor."""
    return torch.from_numpy(np.array(a, np.float32))


def march_inputs(seed=0, R=40, K=24):
    """Ray-march inputs [R, K]: points, unit dirs, sorted t, deltas and a
    prefix mask with per-ray counts 1..K sorted ascending (the
    depth-coherence order the renderer hands the kernel)."""
    rng = np.random.default_rng(seed)
    x = t(rng.uniform(-1.2, 1.2, (R, K, 3)))
    dirs = rng.normal(size=(R, 3))
    dirs = t(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    tv = t(np.sort(rng.uniform(2, 6, (R, K)), axis=-1))
    dl = t(rng.uniform(0.01, 0.06, (R, K)))
    n_valid = np.sort(rng.integers(1, K + 1, R))    # depth-coherence order
    mask = t(np.arange(K)[None, :] < n_valid[:, None])
    return x, dirs, tv, dl, mask


def mlp_inputs(n, seed=0):
    """Train-MLP inputs: points in the scene box, unit view directions and
    an MSE target [n, 4] (rgb in [0, 1], sigma 0), float32 tensors."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, (n, 3))
    d = rng.normal(size=(n, 3))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    target = np.concatenate([rng.uniform(size=(n, 3)), np.zeros((n, 1))], 1)
    return t(x), t(d), t(target)


def mse_cotangent(out, target):
    """d/d out of mean((out - target)^2): the cotangent a loss hands the
    MLP's backward."""
    return (2.0 * (out - target) / out.numel()).contiguous()
