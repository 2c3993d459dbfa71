"""2-D filtering (scipy.signal's image-shaped surface).

``convolve2d``/``correlate2d`` ride ``lax.conv_general_dilated`` — XLA
lowers 2-D convolutions straight to its conv libraries, so no hand
kernel is needed;
boundary handling is explicit padding before a VALID conv, which keeps
every shape static under jit. ``medfilt2d`` stacks the k*k shifted views
and sorts along the stack (zero gathers, like the 1-D rank family);
``sepfir2d`` is two batched 1-D conv passes. No reference analog (the CUDA
study is 1-D audio); parity target is scipy.signal.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_MODES = ("full", "valid", "same")
_BOUNDARIES = ("fill", "wrap", "symm")


@functools.partial(
    jax.jit, static_argnames=("mode", "boundary", "flip", "fillvalue")
)
def _conv2d(x, k, mode: str, boundary: str, flip: bool, fillvalue: float):
    if boundary not in _BOUNDARIES:
        raise ValueError(
            f"boundary must be one of {_BOUNDARIES}, got {boundary!r}"
        )
    xf = jnp.asarray(x, jnp.float32)
    kf = jnp.asarray(k, jnp.float32)
    kh, kw = kf.shape
    batch = xf.shape[:-2]
    xb = xf.reshape((-1,) + xf.shape[-2:])

    if mode == "full":
        ph, pw = (kh - 1, kh - 1), (kw - 1, kw - 1)
    elif mode == "same":
        # centered slice of full: total pad k-1; scipy lands the extra
        # sample BEFORE for convolution and AFTER for correlation (even
        # kernels only — odd splits evenly)
        if flip:
            ph = (kh // 2, (kh - 1) // 2)
            pw = (kw // 2, (kw - 1) // 2)
        else:
            ph = ((kh - 1) // 2, kh // 2)
            pw = ((kw - 1) // 2, kw // 2)
    elif mode == "valid":
        ph = pw = (0, 0)
    else:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")

    if any(ph) or any(pw):
        pads = [(0, 0), ph, pw]
        if boundary == "fill":
            xb = jnp.pad(xb, pads, constant_values=fillvalue)
        elif boundary == "wrap":
            xb = jnp.pad(xb, pads, mode="wrap")
        else:
            xb = jnp.pad(xb, pads, mode="symmetric")

    if flip:  # convolution flips the kernel; correlation doesn't
        kf = kf[::-1, ::-1]
    y = jax.lax.conv_general_dilated(
        xb[:, None],  # NCHW, 1 input feature
        kf[None, None],  # OIHW
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST,
    )[:, 0]
    return y.reshape(batch + y.shape[-2:])


def convolve2d(
    in1: jax.Array,
    in2: jax.Array,
    mode: str = "full",
    boundary: str = "fill",
    fillvalue: float = 0.0,
) -> jax.Array:
    """2-D convolution (scipy.signal.convolve2d). ``in1``'s leading axes
    batch; ``in2`` is the (kh, kw) kernel."""
    return _conv2d(in1, in2, mode, boundary, True, float(fillvalue))


def correlate2d(
    in1: jax.Array,
    in2: jax.Array,
    mode: str = "full",
    boundary: str = "fill",
    fillvalue: float = 0.0,
) -> jax.Array:
    """2-D cross-correlation (scipy.signal.correlate2d)."""
    return _conv2d(in1, in2, mode, boundary, False, float(fillvalue))


@functools.partial(jax.jit, static_argnames=("kernel_size",))
def medfilt2d(x: jax.Array, kernel_size: int | tuple[int, int] = 3) -> jax.Array:
    """2-D sliding median, zero-padded edges (scipy.signal.medfilt2d).

    Builds the kh*kw shifted views of the padded image (pure slices) and
    takes the median down the stacked axis — O(k^2 log k^2) VPU sort, no
    gathers; the standard spelling for the 3x3/5x5 apertures medians see.
    """
    if isinstance(kernel_size, int):
        kh = kw = kernel_size
    else:
        kh, kw = kernel_size
    if kh % 2 == 0 or kw % 2 == 0 or kh < 1 or kw < 1:
        raise ValueError(f"kernel sizes must be odd >= 1, got {(kh, kw)}")
    xf = jnp.asarray(x, jnp.float32)
    h, w = xf.shape[-2:]
    ext = jnp.pad(
        xf,
        [(0, 0)] * (xf.ndim - 2) + [(kh // 2, kh // 2), (kw // 2, kw // 2)],
    )
    views = [
        ext[..., i : i + h, j : j + w]
        for i in range(kh)
        for j in range(kw)
    ]
    return jnp.median(jnp.stack(views, axis=-1), axis=-1)


@jax.jit
def sepfir2d(x: jax.Array, hrow: jax.Array, hcol: jax.Array) -> jax.Array:
    """Separable 2-D FIR with mirror-symmetric boundaries
    (scipy.signal.sepfir2d: odd-length filters, output the input's shape).

    Two 1-D correlations — along rows then columns — each a batched
    conv; the separable split turns a (kh*kw) kernel into kh+kw MACs/pixel.
    """
    xf = jnp.asarray(x, jnp.float32)
    # scipy convolves (kernel flipped); the conv pass below correlates
    hr = jnp.asarray(hrow, jnp.float32).reshape(-1)[::-1]
    hc = jnp.asarray(hcol, jnp.float32).reshape(-1)[::-1]
    if hr.size % 2 == 0 or hc.size % 2 == 0:
        raise ValueError("sepfir2d filters must be odd-length")
    h, w = xf.shape[-2:]
    batch = xf.shape[:-2]
    xb = xf.reshape((-1, h, w))

    def pass_1d(img, f):
        # correlate along the last axis with symmetric (mirror) boundary
        half = f.size // 2
        ext = jnp.pad(img, ((0, 0), (0, 0), (half, half)), mode="symmetric")
        y = jax.lax.conv_general_dilated(
            ext[:, None],
            f[None, None, None, :],
            window_strides=(1, 1),
            padding="VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=jax.lax.Precision.HIGHEST,
        )[:, 0]
        return y

    y = pass_1d(xb, hr)  # rows direction: filter along width
    y = jnp.swapaxes(pass_1d(jnp.swapaxes(y, -1, -2), hc), -1, -2)
    return y.reshape(batch + (h, w))


__all__ = ["convolve2d", "correlate2d", "medfilt2d", "sepfir2d"]
