"""Multi-target tracking over the radar detection stream.

The back end of the radar family: ``models/radar.py`` turns a CPI into a
range-Doppler detection map; this module turns a *stream* of those maps
into confirmed constant-velocity tracks — measurement extraction, gated
association, batched Kalman filtering, M-of-N track management. North-star
scope like the rest of the model families (the CUDA reference has no
radar/tracking models; SURVEY.md §6).

Design choices (everything is static-shape and gather-free so the whole
CPI stream rides ONE ``lax.scan``):
- a FIXED array of track slots (``max_tracks``): states ``(T, 2)``,
  covariances ``(T, 2, 2)``, hit/miss counters — each CPI is one batched
  closed-form 2x2 Kalman predict/update, never per-track Python objects;
- measurement extraction = 8-neighbour local-max test + ``top_k``
  (static ``max_meas``), never a dynamic ``nonzero``;
- association = gated Mahalanobis cost matrix + greedy global-argmin
  assignment as a ``lax.scan`` of ``max_tracks`` steps, each step one
  masked reduction over the ``(T, M)`` cost;
- assigned measurements are routed to tracks by a one-hot MATMUL, and new
  tracks claim free slots by rank-matching (cumsum equality matmul) —
  no scatters.

The measurement space is (range bin, radial velocity) with velocity in
range-bins/CPI; Doppler (cycles/PRI) maps to velocity through
``TrackerConfig.vel_scale``, so the filter observes both state components
directly (H = I) and the 2x2 innovation algebra stays closed-form.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "TrackerConfig",
    "TrackerState",
    "tracker_init",
    "extract_measurements",
    "tracker_step",
    "track_cpis",
    "track_detections",
]

_INF = jnp.inf


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Constant-velocity tracker over (range, velocity) measurements.

    ``gate`` is a squared-Mahalanobis gate (chi-square with 2 dof: 9.21 is
    the 99% point). ``vel_scale`` converts Doppler in cycles/PRI to
    velocity in range-bins/CPI (scenario geometry; positive Doppler =
    increasing range here). ``confirm_hits``/``max_misses`` are the M-of-N
    manager: a track is confirmed after ``confirm_hits`` total hits and
    dropped after ``max_misses`` consecutive misses.
    """

    max_tracks: int = 16
    max_meas: int = 16
    dt: float = 1.0  # CPI interval, the state time unit
    sigma_r: float = 0.5  # range measurement std (bins)
    sigma_v: float = 0.1  # velocity measurement std (bins/CPI)
    accel_var: float = 0.01  # CV white-acceleration variance
    gate: float = 9.21
    confirm_hits: int = 3
    max_misses: int = 2
    init_pos_var: float = 4.0  # new-track position variance
    init_vel_var: float = 1.0  # new-track velocity variance
    vel_scale: float = 1.0  # bins/CPI per cycles/PRI

    def __post_init__(self):
        if self.max_tracks < 1 or self.max_meas < 1:
            raise ValueError("max_tracks and max_meas must be >= 1")
        if self.gate <= 0.0:
            raise ValueError(f"gate must be > 0, got {self.gate}")


class TrackerState(NamedTuple):
    """One pytree of fixed-size track slots (scan carry)."""

    x: jax.Array  # (T, 2) [range_bin, velocity]
    cov: jax.Array  # (T, 2, 2)
    active: jax.Array  # (T,) bool
    hits: jax.Array  # (T,) int32 total hits
    misses: jax.Array  # (T,) int32 consecutive misses
    tid: jax.Array  # (T,) int32 track id (0 = slot never used)
    next_id: jax.Array  # () int32


def tracker_init(cfg: TrackerConfig) -> TrackerState:
    t = cfg.max_tracks
    return TrackerState(
        x=jnp.zeros((t, 2), jnp.float32),
        cov=jnp.zeros((t, 2, 2), jnp.float32),
        active=jnp.zeros((t,), bool),
        hits=jnp.zeros((t,), jnp.int32),
        misses=jnp.zeros((t,), jnp.int32),
        tid=jnp.zeros((t,), jnp.int32),
        next_id=jnp.asarray(1, jnp.int32),
    )


def extract_measurements(
    det: jax.Array,
    power: jax.Array,
    *,
    max_meas: int,
    vel_scale: float = 1.0,
) -> tuple[jax.Array, jax.Array]:
    """Detection map -> up to ``max_meas`` point measurements.

    ``det``/``power``: (n_dopplers, n_ranges) from ``radar.detect``. A CFAR
    blob around one target is collapsed to its peak cell by an 8-neighbour
    strict local-max test; the ``max_meas`` strongest peaks survive via
    ``top_k`` (static shapes — no dynamic ``nonzero``). Doppler rows are
    fftshifted (row d = (d - D//2)/D cycles/PRI, matching
    ``radar.doppler_map``). Returns ``(z, valid)`` with ``z`` of shape
    ``(max_meas, 2)`` = (range bin, velocity in bins/CPI).
    """
    p = power.astype(jnp.float32)
    n_dop, n_rng = p.shape
    pp = jnp.pad(p, 1, constant_values=-_INF)
    neigh = jnp.stack(
        [
            pp[1 + di : 1 + di + n_dop, 1 + dj : 1 + dj + n_rng]
            for di in (-1, 0, 1)
            for dj in (-1, 0, 1)
            if (di, dj) != (0, 0)
        ]
    ).max(axis=0)
    score = jnp.where(det & (p > neigh), p, -_INF)
    vals, idx = jax.lax.top_k(score.reshape(-1), max_meas)
    valid = jnp.isfinite(vals)
    row = (idx // n_rng).astype(jnp.float32)
    col = (idx % n_rng).astype(jnp.float32)
    doppler = (row - n_dop // 2) / n_dop  # cycles/PRI
    z = jnp.stack([col, doppler * vel_scale], axis=-1)
    return jnp.where(valid[:, None], z, 0.0), valid


def _model_mats(cfg: TrackerConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Constant-velocity F, discrete white-acceleration Q, measurement R."""
    dt = cfg.dt
    f = np.array([[1.0, dt], [0.0, 1.0]], np.float32)
    q = cfg.accel_var * np.array(
        [[dt**4 / 4.0, dt**3 / 2.0], [dt**3 / 2.0, dt**2]], np.float32
    )
    r = np.diag([cfg.sigma_r**2, cfg.sigma_v**2]).astype(np.float32)
    return f, q, r


def _inv2(m: jax.Array) -> jax.Array:
    """Batched closed-form 2x2 inverse, (..., 2, 2)."""
    a = m[..., 0, 0]
    b = m[..., 0, 1]
    c = m[..., 1, 0]
    d = m[..., 1, 1]
    det = a * d - b * c
    inv = jnp.stack(
        [jnp.stack([d, -b], -1), jnp.stack([-c, a], -1)], -2
    )
    return inv / det[..., None, None]


def _greedy_assign(cost: jax.Array, n_steps: int) -> tuple[jax.Array, jax.Array]:
    """Greedy global-argmin assignment on a (T, M) cost matrix.

    Infeasible pairs carry +inf. Returns ``(assign, used)``: per-track
    measurement index (-1 = unassigned) and the per-measurement used mask.
    Each of the ``n_steps`` scan steps claims the current global minimum
    and masks its row and column — one reduction per step, static shapes.
    """
    n_t, n_m = cost.shape
    t_ids = jnp.arange(n_t)
    m_ids = jnp.arange(n_m)

    def step(carry, _):
        c, assign, used = carry
        flat = jnp.argmin(c.reshape(-1))
        val = c.reshape(-1)[flat]
        t = flat // n_m
        m = flat % n_m
        ok = jnp.isfinite(val)
        assign = jnp.where(ok & (t_ids == t), m, assign)
        used = used | (ok & (m_ids == m))
        c = jnp.where(ok & ((t_ids[:, None] == t) | (m_ids[None, :] == m)), _INF, c)
        return (c, assign, used), None

    init = (cost, jnp.full((n_t,), -1, jnp.int32), jnp.zeros((n_m,), bool))
    (_, assign, used), _ = jax.lax.scan(step, init, None, length=n_steps)
    return assign, used


@functools.partial(jax.jit, static_argnames=("cfg",))
def tracker_step(
    cfg: TrackerConfig,
    state: TrackerState,
    z: jax.Array,
    valid: jax.Array,
) -> tuple[TrackerState, dict]:
    """One CPI: predict -> gate/associate -> update -> manage -> spawn.

    ``z``: (max_meas, 2) measurements, ``valid`` their mask. Returns the
    new state plus a per-slot snapshot dict (x, active, confirmed, tid)
    taken AFTER spawn/drop, so scanning this body yields the track history.
    """
    f_np, q_np, r_np = _model_mats(cfg)
    f = jnp.asarray(f_np)
    q = jnp.asarray(q_np)
    r = jnp.asarray(r_np)
    eye = jnp.eye(2, dtype=jnp.float32)
    # every contraction here is 2x2-class Kalman algebra: force full-f32
    # matmuls. A reduced-precision default (bf16 or TF32) can drift the
    # covariances enough over a 16-CPI stream to pull a confirmed track
    # bins off its float32 position.
    hp = jax.lax.Precision.HIGHEST

    # Predict (batched over slots; inactive slots carry garbage, masked out
    # of the cost below).
    x = jnp.matmul(state.x, f.T, precision=hp)
    cov = jnp.einsum("ij,tjk,lk->til", f, state.cov, f, precision=hp) + q

    # Gated Mahalanobis cost, (T, M). H = I so S = P + R.
    s = cov + r
    s_inv = _inv2(s)
    y = z[None, :, :] - x[:, None, :]  # (T, M, 2)
    d2 = jnp.einsum("tmi,tij,tmj->tm", y, s_inv, y, precision=hp)
    feasible = state.active[:, None] & valid[None, :] & (d2 <= cfg.gate)
    cost = jnp.where(feasible, d2, _INF)

    assign, used = _greedy_assign(cost, min(cfg.max_tracks, cfg.max_meas))
    assigned = assign >= 0

    # Route each track's measurement with a one-hot matmul (gather-free).
    onehot = (
        (assign[:, None] == jnp.arange(cfg.max_meas)[None, :]) & assigned[:, None]
    ).astype(jnp.float32)
    zz = jnp.matmul(onehot, z, precision=hp)  # (T, 2); zeros if unassigned
    innov = zz - x
    gain = jnp.einsum("tij,tjk->tik", cov, s_inv, precision=hp)
    x_upd = x + jnp.einsum("tij,tj->ti", gain, innov, precision=hp)
    cov_upd = jnp.einsum("tij,tjk->tik", eye[None] - gain, cov, precision=hp)
    x = jnp.where(assigned[:, None], x_upd, x)
    cov = jnp.where(assigned[:, None, None], cov_upd, cov)

    # M-of-N management.
    hits = jnp.where(assigned, state.hits + 1, state.hits)
    misses = jnp.where(
        assigned, 0, jnp.where(state.active, state.misses + 1, state.misses)
    )
    active = state.active & (misses <= cfg.max_misses)

    # Spawn: rank-match unassigned measurements to free slots (cumsum
    # equality — the i-th free slot claims the i-th leftover measurement).
    leftover = valid & ~used
    free = ~active
    free_rank = jnp.cumsum(free.astype(jnp.int32))
    meas_rank = jnp.cumsum(leftover.astype(jnp.int32))
    match = (
        free[:, None]
        & leftover[None, :]
        & (free_rank[:, None] == meas_rank[None, :])
    )
    spawned = match.any(axis=1)
    z_new = jnp.matmul(match.astype(jnp.float32), z, precision=jax.lax.Precision.HIGHEST)
    p_new = jnp.diag(
        jnp.asarray([cfg.init_pos_var, cfg.init_vel_var], jnp.float32)
    )
    x = jnp.where(spawned[:, None], z_new, x)
    cov = jnp.where(spawned[:, None, None], p_new[None], cov)
    hits = jnp.where(spawned, 1, hits)
    misses = jnp.where(spawned, 0, misses)
    spawn_rank = jnp.cumsum(spawned.astype(jnp.int32))
    tid = jnp.where(spawned, state.next_id - 1 + spawn_rank, state.tid)
    next_id = state.next_id + spawned.sum(dtype=jnp.int32)
    active = active | spawned

    new_state = TrackerState(x, cov, active, hits, misses, tid, next_id)
    out = {
        "x": x,
        "active": active,
        "confirmed": active & (hits >= cfg.confirm_hits),
        "tid": tid,
    }
    return new_state, out


def track_cpis(
    cfg: TrackerConfig, zs: jax.Array, valids: jax.Array
) -> tuple[TrackerState, dict]:
    """Scan the tracker over a measurement stream.

    ``zs``: (n_cpis, max_meas, 2), ``valids``: (n_cpis, max_meas). Returns
    the final state and the stacked per-CPI snapshots (each leading axis
    n_cpis).
    """
    return jax.lax.scan(
        lambda s, inp: tracker_step(cfg, s, *inp), tracker_init(cfg), (zs, valids)
    )


def track_detections(rcfg, tcfg: TrackerConfig, i: jax.Array, q: jax.Array):
    """End-to-end: a time-ordered stack of CPIs -> track history.

    ``i``/``q``: (n_cpis, n_pulses, n_range) planar echoes. Detection and
    measurement extraction are batched over CPIs (the dp story —
    ``radar.detect_batch`` shards the same vmap over a mesh); only the
    tracker scan is sequential, as the recursion demands.
    """
    from . import radar

    det, power, _ = jax.vmap(lambda a, b: radar.detect(rcfg, a, b))(i, q)
    zs, valids = jax.vmap(
        lambda d, p: extract_measurements(
            d, p, max_meas=tcfg.max_meas, vel_scale=tcfg.vel_scale
        )
    )(det, power)
    return track_cpis(tcfg, zs, valids)
