"""The JAX package's parameter draws for the six balancing ops, as the port's
`ops/augment.py` op functions take them.

`jax_params(transform, keys, hw)` repeats each JAX op's key splits and
draws (`leaffliction_tpu/ops/augment.py`: `_flip_one`, `_rotate_one`,
`_skew_one`, `_shear_one`, `_crop_one`, `_distortion_one` and its strict
twin) and returns the values as the keyword arguments of the port's
`<op>_batch`, so a test can run both packages on the same draws.
`jax_task_keys` gives the fused balancer's per-task keys
(`fold_in(key(seed), task_seed)`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from leaffliction_tpu.ops import augment as ja
from leaffliction_tpu_torch.ops.augment import crop_corner


def jax_task_keys(seed, task_seeds):
    root = jax.random.key(seed)
    return jax.vmap(lambda s: jax.random.fold_in(root, s))(
        jnp.asarray(np.asarray(task_seeds, np.uint32)))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def jax_params(transform, keys, hw, strict=False):
    h, w = hw
    u = jax.random.uniform
    if transform == "flip":
        return {"horizontal": _t(jax.vmap(jax.random.bernoulli)(keys),
                                 torch.bool)}
    if transform == "rotate":
        return {"angles": _t(jax.vmap(lambda k: u(
            k, (), jnp.float32, -ja.MAX_ROTATE_DEG, ja.MAX_ROTATE_DEG))(
                keys))}
    if transform == "skew":
        return {"s": _t(jax.vmap(lambda k: u(
            k, (), jnp.float32, *ja.SKEW_RANGE))(keys))}
    if transform == "shear":
        def shear(k):
            k_dir, k_s = jax.random.split(k)
            return (u(k_s, (), jnp.float32, -ja.SHEAR_MAX, ja.SHEAR_MAX),
                    jax.random.bernoulli(k_dir))

        s, horiz = jax.vmap(shear)(keys)
        return {"s": _t(s), "horizontal": _t(horiz, torch.bool)}
    if transform == "crop":
        def crop(k):
            k_ratio, k_left, k_top = jax.random.split(k, 3)
            return (u(k_ratio, (), jnp.float32, *ja.CROP_RATIO_RANGE),
                    u(k_left, ()), u(k_top, ()))

        ratio, u_left, u_top = (_t(v) for v in jax.vmap(crop)(keys))
        left, top = crop_corner(ratio, u_left, u_top, hw)
        return {"ratio": ratio, "left": left, "top": top}
    assert transform == "distortion"
    noise_fn = ja._noise_strict if strict else ja._noise

    def distortion(k):
        k_noise, k_cut = jax.random.split(k)
        return (noise_fn(k_noise, (h, w, 3)),
                u(k_cut, (), jnp.float32, 0.0, ja.CUTOFF_MAX))

    noise, cutoffs = jax.vmap(distortion)(keys)
    return {"noise": _t(noise), "cutoffs": _t(cutoffs), "strict": strict}


def jax_kmeans_init(n, k, seed):
    """The initial centre indices `leaffliction_tpu/ops/kmeans.py` draws
    (`jax.random.choice(key(seed), n, (k,), replace=False)`), as the port's
    `ops/kmeans.init_indices` returns them."""
    idx = jax.random.choice(jax.random.key(seed), n, (k,), replace=False)
    return torch.from_numpy(np.asarray(idx).astype(np.int64))
