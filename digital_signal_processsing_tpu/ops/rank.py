"""Order-statistic and adaptive smoothing filters: medfilt, rank, Wiener.

Beyond-reference framework surface (scipy.signal parity: medfilt,
order_filter-style rank filtering, wiener). Shape: a sliding-window
order statistic is a sort over a stacked-shift axis — k shifted VIEWS of
the stream (no gathers), sorted along the small window axis.
The Wiener filter's local moments ride the same centered lane-blocked
conv as every other windowed op (ops/fir.blocked_causal_conv).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .fir import _as_planar, _centered_fir


def _sliding_windows(xf: jax.Array, k: int) -> jax.Array:
    """(c, t, k) zero-padded centered windows from k shifted slices."""
    c, t = xf.shape
    half = k // 2
    ext = jnp.pad(xf, ((0, 0), (half, half)))
    return jnp.stack([ext[:, i : i + t] for i in range(k)], axis=-1)


@functools.partial(jax.jit, static_argnames=("kernel_size",))
def medfilt(x: jax.Array, kernel_size: int = 3) -> jax.Array:
    """Sliding-window median (scipy.signal.medfilt: odd window, zero pad).

    Sorts the k stacked shifts per sample — O(k log k) work but zero
    gathers; fine
    for the small apertures medians are used at.
    """
    if kernel_size % 2 == 0 or kernel_size < 1:
        raise ValueError(f"kernel_size must be odd >= 1, got {kernel_size}")
    xp, squeeze = _as_planar(x)
    w = _sliding_windows(xp.astype(jnp.float32), kernel_size)
    y = jnp.median(w, axis=-1)
    return y[0] if squeeze else y


@functools.partial(jax.jit, static_argnames=("kernel_size", "rank"))
def rank_filter(x: jax.Array, kernel_size: int, rank: int) -> jax.Array:
    """Sliding-window rank filter: the ``rank``-th smallest of each
    centered zero-padded window (scipy.ndimage.rank_filter semantics;
    rank 0 = erosion/min, k-1 = dilation/max, (k-1)//2 = medfilt)."""
    if kernel_size % 2 == 0 or kernel_size < 1:
        raise ValueError(f"kernel_size must be odd >= 1, got {kernel_size}")
    if not 0 <= rank < kernel_size:
        raise ValueError(f"rank must be in [0, {kernel_size}), got {rank}")
    xp, squeeze = _as_planar(x)
    w = _sliding_windows(xp.astype(jnp.float32), kernel_size)
    y = jnp.sort(w, axis=-1)[..., rank]
    return y[0] if squeeze else y


@functools.partial(jax.jit, static_argnames=("mysize",))
def wiener(x: jax.Array, mysize: int = 3, noise: float | None = None) -> jax.Array:
    """Adaptive local-statistics Wiener filter (scipy.signal.wiener, 1-D).

    Local mean and variance come from two centered box correlations (the
    lane-blocked conv); where the local variance falls below the noise
    floor the output collapses to the local mean. ``noise=None`` estimates
    the floor as the mean local variance, like scipy.
    """
    if mysize % 2 == 0 or mysize < 1:
        raise ValueError(f"mysize must be odd >= 1, got {mysize}")
    xp, squeeze = _as_planar(x)
    xf = xp.astype(jnp.float32)
    half = mysize // 2
    box = np.full(mysize, 1.0 / mysize)
    ext = jnp.pad(xf, ((0, 0), (half, half)))
    l_mean = _centered_fir(ext, box)
    ext2 = jnp.pad(xf * xf, ((0, 0), (half, half)))
    l_var = _centered_fir(ext2, box) - l_mean * l_mean
    nz = jnp.mean(l_var, axis=-1, keepdims=True) if noise is None else jnp.float32(noise)
    res = l_mean + (1.0 - nz / jnp.maximum(l_var, 1e-30)) * (xf - l_mean)
    y = jnp.where(l_var < nz, l_mean, res)
    return y[0] if squeeze else y


@functools.partial(
    jax.jit, static_argnames=("domain", "rank", "domain_shape")
)
def _order_filter_nd(x, domain, rank, domain_shape):
    views = []
    nd = x.ndim
    pads = [(s // 2, s // 2) for s in domain_shape]
    ext = jnp.pad(x, pads)
    dom = np.asarray(domain).reshape(domain_shape).astype(bool)
    for offs in np.ndindex(*domain_shape):
        if not dom[offs]:
            continue
        sl = tuple(
            slice(o, o + n) for o, n in zip(offs, x.shape)
        )
        views.append(ext[sl])
    stack = jnp.stack(views, axis=-1)
    return jnp.sort(stack, axis=-1)[..., rank]


def order_filter(x: jax.Array, domain, rank: int) -> jax.Array:
    """N-D order filter over an arbitrary 0/1 neighborhood mask
    (scipy.signal.order_filter: odd domain sides, zero-padded edges).
    Stacked shifted views + one VPU sort — no gathers, like the 1-D rank
    family."""
    domain = np.asarray(domain)
    if any(s % 2 == 0 for s in domain.shape):
        raise ValueError("domain sides must be odd")
    if domain.ndim != jnp.ndim(x):
        raise ValueError("domain rank must match input rank")
    nnz = int(np.count_nonzero(domain))
    if not 0 <= rank < nnz:
        raise ValueError(f"rank must be in [0, {nnz}), got {rank}")
    return _order_filter_nd(
        jnp.asarray(x, jnp.float32), tuple(domain.astype(int).ravel()),
        rank, domain.shape
    )
