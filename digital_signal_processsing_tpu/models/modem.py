"""Single-carrier QAM modem: RRC shaping, matched filter, batch sync, LS EQ.

Third communications model family beside the FM chain (continuous-stream
demod, models/chain.py) and the OFDM receiver (framed spectra,
models/ofdm.py): the classic single-carrier linear link — Gray-mapped
square QAM through root-raised-cosine pulses — exercising the framework's
interpolating conv (ops.resample.upfirdn), matched filtering
(ops.fir.fir_filter), spectral estimation and small-solve pieces end to
end. North-star scope like models/ofdm.py (the CUDA reference has no
comms models; SURVEY.md §6).

Design choices:
- pulse shaping and matched filtering ride the banded tap matrix —
  never an lhs-dilated or single-feature conv (the 1/128-utilization trap);
- NO sample-serial synchronization loops: timing is the Oerder-Meyr
  cyclic-spectral estimate (one |y|^2 reduction against one complex
  exponential), frame sync is a preamble-correlation argmax, carrier
  recovery is a coarse 4th-power spectral line plus a data-aided phase
  slope over the preamble — every stage a batched reduction;
- the equalizer is a one-shot ridge-regularized least-squares solve on the
  preamble (normal equations in real block form, one small dense solve)
  instead of a serial adaptive pass;
- planar I/Q at every host<->device boundary (complex64 transfers are
  second-class on some PJRT backends); complex forms on device via
  lax.complex.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fir import design_rrc, fir_filter
from ..ops.resample import upfirdn

__all__ = [
    "ModemConfig",
    "map_bits",
    "demap_symbols",
    "preamble_symbols",
    "transmit",
    "channel",
    "receive",
]


@dataclasses.dataclass(frozen=True)
class ModemConfig:
    """Link parameters. ``bits_per_symbol``: 1 (BPSK), 2 (QPSK), 4 (16QAM),
    6 (64QAM). ``rrc_span``: pulse length in symbols (taps = span*sps + 1)."""

    bits_per_symbol: int = 2
    sps: int = 8
    beta: float = 0.35
    rrc_span: int = 10
    preamble_len: int = 64  # QPSK symbols, known at the receiver
    preamble_seed: int = 17
    eq_taps: int = 9  # symbol-spaced, odd (centered reference tap)
    eq_ridge: float = 1e-4
    dd_block: int = 32  # decision-directed phase-tracking block (symbols)
    # scan unroll for the tracking loop. Bit-identical at any value (same op
    # sequence, fewer loop-machinery iterations); 4 was chosen on the
    # earlier accelerator and is not yet measured on a GPU
    dd_unroll: int = 4
    # phase tracker engine: "dd" = serial decision-directed scan,
    # "vv" = parallel smoothed power-m + unwrap + parallel DD refine
    # (_vv_phase_track — no serial loop). Engines differ in cycle-slip
    # statistics at the waterfall bottom; the default keeps the serial
    # engine (ROADMAP design debt 4).
    tracker: str = "dd"
    vv_smooth: int = 5  # blocks averaged per coarse power-m estimate
    vv_refine: int = 2  # parallel decision-directed refine rounds

    def __post_init__(self):
        if self.bits_per_symbol not in (1, 2, 4, 6):
            raise ValueError(
                f"bits_per_symbol must be 1/2/4/6, got {self.bits_per_symbol}"
            )
        if self.eq_taps % 2 == 0:
            raise ValueError(f"eq_taps must be odd, got {self.eq_taps}")
        if self.tracker not in ("dd", "vv"):
            raise ValueError(f"tracker must be 'dd' or 'vv', got {self.tracker}")

    @property
    def rrc_num_taps(self) -> int:
        return self.rrc_span * self.sps + 1

    def rrc(self) -> np.ndarray:
        return design_rrc(self.rrc_num_taps, self.beta, self.sps)


def _axis_params(bits_per_symbol: int) -> tuple[int, int, float]:
    """(bits per axis, levels per axis, amplitude scale) for square QAM."""
    k = bits_per_symbol // 2
    lvl = 1 << k
    scale = float(np.sqrt(3.0 / (2.0 * (lvl * lvl - 1))))
    return k, lvl, scale


def _gray_decode(g: np.ndarray) -> np.ndarray:
    """Binary-reflected Gray code -> level index (numpy ints)."""
    i = np.asarray(g).copy()
    shift = 1
    while shift < 16:
        i ^= i >> shift
        shift *= 2
    return i


def map_bits(bits, bits_per_symbol: int) -> np.ndarray:
    """Host bit-to-symbol mapper (the test oracle's transmitter side).

    Gray-mapped unit-average-energy square QAM: the first half of each
    symbol's bits (MSB first) select the I level, the second half the Q
    level. BPSK (1 bit): antipodal on the real axis.
    """
    b = np.asarray(bits).astype(np.int64).reshape(-1)
    if b.size % bits_per_symbol:
        raise ValueError(
            f"bit count {b.size} not a multiple of {bits_per_symbol}"
        )
    if np.any((b < 0) | (b > 1)):
        raise ValueError("bits must be 0/1")
    if bits_per_symbol == 1:
        return (1.0 - 2.0 * b).astype(np.complex128)
    k, lvl, scale = _axis_params(bits_per_symbol)
    b = b.reshape(-1, bits_per_symbol)
    weights = 1 << np.arange(k - 1, -1, -1)
    gi = (b[:, :k] * weights).sum(axis=1)
    gq = (b[:, k:] * weights).sum(axis=1)
    ai = 2 * _gray_decode(gi) - (lvl - 1)
    aq = 2 * _gray_decode(gq) - (lvl - 1)
    return scale * (ai + 1j * aq)


def demap_symbols(yr: jax.Array, yi: jax.Array, bits_per_symbol: int) -> jax.Array:
    """Hard-decision Gray demapper (jittable; planar symbol-rate input).

    Returns int32 bits, shape (n * bits_per_symbol,). The Gray re-encode is
    pure integer bit math (i ^ (i >> 1)) — no lookup gathers.
    """
    if bits_per_symbol == 1:
        return (yr < 0).astype(jnp.int32)
    k, lvl, scale = _axis_params(bits_per_symbol)

    def axis_bits(y):
        idx = jnp.clip(
            jnp.round((y / scale + (lvl - 1)) * 0.5), 0, lvl - 1
        ).astype(jnp.int32)
        g = idx ^ (idx >> 1)
        return jnp.stack(
            [(g >> (k - 1 - j)) & 1 for j in range(k)], axis=-1
        )

    bits = jnp.concatenate([axis_bits(yr), axis_bits(yi)], axis=-1)
    return bits.reshape(-1)


def preamble_symbols(cfg: ModemConfig) -> np.ndarray:
    """The known QPSK preamble (same for any payload constellation)."""
    rng = np.random.default_rng(cfg.preamble_seed)
    bits = rng.integers(0, 2, 2 * cfg.preamble_len)
    return map_bits(bits, 2)


def transmit(cfg: ModemConfig, bits) -> tuple[np.ndarray, np.ndarray]:
    """[preamble | payload] -> RRC-shaped planar (i, q) at sps rate.

    The zero-stuffing interpolation is ops.resample.upfirdn's banded
    tap matrix; output length (n_sym - 1) * sps + rrc_num_taps.
    """
    syms = np.concatenate(
        [preamble_symbols(cfg), map_bits(bits, cfg.bits_per_symbol)]
    )
    h = cfg.rrc()
    si = jnp.asarray(syms.real, jnp.float32)
    sq = jnp.asarray(syms.imag, jnp.float32)
    return (
        np.asarray(upfirdn(h, si, up=cfg.sps)),
        np.asarray(upfirdn(h, sq, up=cfg.sps)),
    )


def channel(
    i,
    q,
    *,
    delay: int = 0,
    cfo: float = 0.0,
    phase: float = 0.0,
    symbol_snr_db: float | None = None,
    taps=None,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side impairment simulator (numpy; the tests' channel oracle).

    ``cfo`` in cycles/sample (applied as exp(+2j pi cfo n)); ``taps``: an
    optional complex sample-rate multipath response; ``symbol_snr_db``:
    Es/N0 at the matched-filter output — with the unit-energy RRC and
    unit-average-energy constellations this equals 1/sigma^2 for complex
    per-sample noise variance sigma^2, so sigma^2 = 10^(-snr/10).
    """
    x = np.asarray(i, np.float64) + 1j * np.asarray(q, np.float64)
    if taps is not None:
        x = np.convolve(x, np.asarray(taps, np.complex128))
    if delay:
        x = np.concatenate([np.zeros(delay, np.complex128), x])
    n = np.arange(x.size)
    x = x * np.exp(1j * (phase + 2.0 * np.pi * cfo * n))
    if symbol_snr_db is not None:
        rng = np.random.default_rng(seed)
        sigma = np.sqrt(10.0 ** (-symbol_snr_db / 10.0) / 2.0)
        x = x + sigma * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
    return x.real.astype(np.float32), x.imag.astype(np.float32)


def _matched_filter(cfg: ModemConfig, x: jax.Array) -> jax.Array:
    yr = fir_filter(jnp.real(x), jnp.asarray(cfg.rrc()))
    yi = fir_filter(jnp.imag(x), jnp.asarray(cfg.rrc()))
    return jax.lax.complex(yr, yi)


def _coarse_cfo(r: jax.Array, power: int) -> jax.Array:
    """Spectral-line carrier estimate: argmax of |FFT(r^power)| / power.

    Square constellations have E[s^power] != 0 at power 4 (2 for BPSK), so
    r^power carries a line at power*cfo; capture range |cfo| < 1/(2*power)
    of the input rate. Runs at SYMBOL rate — on the sps-rate stream the
    inter-symbol samples dilute the line enough to drown it below ~10 dB,
    while the symbol-rate line survives to ~0 dB.
    """
    z = r**power
    nfft = 1 << int(np.ceil(np.log2(z.shape[-1])))
    s = jnp.fft.fft(z, n=nfft)
    k = jnp.argmax(jnp.abs(s))
    f = k.astype(jnp.float32) / nfft
    f = jnp.where(f >= 0.5, f - 1.0, f)
    return f / power


def _oerder_meyr(y: jax.Array, sps: int) -> tuple[jax.Array, jax.Array]:
    """(integer phase, fractional offset in samples) from one |y|^2 line."""
    n = y.shape[-1]
    p2 = jnp.abs(y) ** 2
    w = -2.0 * jnp.pi * (jnp.arange(n) % sps).astype(jnp.float32) / sps
    m_re = jnp.sum(p2 * jnp.cos(w))
    m_im = jnp.sum(p2 * jnp.sin(w))
    tau = (-jnp.arctan2(m_im, m_re) / (2.0 * jnp.pi) * sps) % sps
    phase = jnp.round(tau).astype(jnp.int32) % sps
    return phase, tau


def _preamble_sync(r: jax.Array, pre: np.ndarray) -> jax.Array:
    """argmax |<r[k:k+P], pre>| over k — one planar complex valid
    correlation through ops.correlate's matmul-DFT engine."""
    from ..ops.correlate import correlate_complex

    c_re, c_im = correlate_complex(
        jnp.real(r),
        jnp.imag(r),
        jnp.asarray(pre.real, jnp.float32),
        jnp.asarray(pre.imag, jnp.float32),
        mode="valid",
    )
    return jnp.argmax(c_re**2 + c_im**2)


def _symbol_frames(seg: jax.Array, n_out: int, n_taps: int) -> jax.Array:
    """(n_out, n_taps) frames F[k, j] = seg_padded[k + j] with a centered
    reference: seg is pre-padded by n_taps//2 zeros by the caller. Built
    from n_taps shifted static slices — no gather."""
    cols = [seg[j : j + n_out] for j in range(n_taps)]
    return jnp.stack(cols, axis=-1)


def _ls_equalizer(frames: jax.Array, target: jax.Array, ridge: float) -> jax.Array:
    """Ridge LS taps for min ||F w - t||^2 in real block form (one small
    dense solve; complex linalg stays off the device-facing path)."""
    fr, fi = jnp.real(frames), jnp.imag(frames)
    a = jnp.concatenate(
        [
            jnp.concatenate([fr, -fi], axis=1),
            jnp.concatenate([fi, fr], axis=1),
        ],
        axis=0,
    )
    b = jnp.concatenate([jnp.real(target), jnp.imag(target)])
    t2 = a.shape[1]
    ata = a.T @ a + ridge * jnp.eye(t2, dtype=jnp.float32)
    w = jnp.linalg.solve(ata, a.T @ b)
    half = t2 // 2
    return jax.lax.complex(w[:half], w[half:])


def _decide(yr: jax.Array, yi: jax.Array, bits_per_symbol: int):
    """Nearest-constellation-point planar decisions (jittable)."""
    if bits_per_symbol == 1:
        return jnp.where(yr < 0, -1.0, 1.0), jnp.zeros_like(yi)
    _, lvl, scale = _axis_params(bits_per_symbol)

    def axis(y):
        idx = jnp.clip(jnp.round((y / scale + (lvl - 1)) * 0.5), 0, lvl - 1)
        return (2.0 * idx - (lvl - 1)) * scale

    return axis(yr), axis(yi)


def _dd_phase_track(
    eq: jax.Array,
    known_r: jax.Array,
    known_i: jax.Array,
    known_mask: jax.Array,
    bits_per_symbol: int,
    block: int,
    unroll: int = 1,
) -> jax.Array:
    """Blockwise decision-directed carrier phase tracking.

    Preamble-only frequency estimates bottom out near the 64-symbol CRB
    (~4e-5 cycles/symbol), which still rotates a 1000-symbol payload tens
    of degrees — so the payload itself must carry the tracking, as in any
    burst receiver. Spelling: a first-order phase loop at BLOCK
    granularity — each step is a full-block batched reduction (decisions,
    one conj-product sum, one atan2), and the serial dimension is only
    n_symbols/block iterations of lax.scan. Known symbols (the preamble)
    anchor the loop; zero-padded tail symbols contribute nothing to the
    error sum.
    """
    n = eq.shape[-1]
    nb = -(-n // block)
    pad = nb * block - n
    yr = jnp.pad(jnp.real(eq), (0, pad)).reshape(nb, block)
    yi = jnp.pad(jnp.imag(eq), (0, pad)).reshape(nb, block)
    kr = jnp.pad(known_r, (0, pad)).reshape(nb, block)
    ki = jnp.pad(known_i, (0, pad)).reshape(nb, block)
    km = jnp.pad(known_mask, (0, pad)).reshape(nb, block)

    def body(phi, inp):
        br, bi, bkr, bki, bkm = inp
        c, s = jnp.cos(phi), jnp.sin(phi)
        r1 = br * c + bi * s  # y * exp(-j phi)
        i1 = bi * c - br * s
        dr, di = _decide(r1, i1, bits_per_symbol)
        rr = jnp.where(bkm, bkr, dr)
        ri = jnp.where(bkm, bki, di)
        e_re = jnp.sum(r1 * rr + i1 * ri)
        e_im = jnp.sum(i1 * rr - r1 * ri)
        e = jnp.arctan2(e_im, e_re)
        ce, se = jnp.cos(e), jnp.sin(e)
        return phi + e, (r1 * ce + i1 * se, i1 * ce - r1 * se)

    # unroll: same op sequence (bit-identical output), fewer loop-machinery
    # iterations — the scan is latency-bound at (block,) shapes
    _, (out_r, out_i) = jax.lax.scan(
        body, jnp.float32(0.0), (yr, yi, kr, ki, km), unroll=unroll
    )
    return jax.lax.complex(out_r.reshape(-1)[:n], out_i.reshape(-1)[:n])


def _vv_phase_track(
    eq: jax.Array,
    known_r: jax.Array,
    known_i: jax.Array,
    known_mask: jax.Array,
    bits_per_symbol: int,
    block: int,
    smooth: int = 5,
    refine: int = 2,
) -> jax.Array:
    """Parallel blockwise phase tracking (no serial loop at all).

    The DD scan (:func:`_dd_phase_track`) is latency-bound: a loop-step
    launch cost x n/block sequential steps. This engine
    replaces the serial dependency with four batched passes:

    1. **Coarse, decision-free per-block phase**: the power-m estimator
       (m=2 BPSK, m=4 QAM — arg E[s^4] is real-negative for square QAM, so
       arg(sum y^4) ~ 4*phi + pi), block sums smoothed over ``smooth``
       neighbor blocks (one tiny 1-D conv) to average the 4th-power noise
       down before differencing.
    2. **Unwrap**: block-to-block diffs wrapped into (-pi/m, pi/m], then a
       parallel cumsum — the only cross-block coupling, log-depth instead
       of 2050 serial steps.
    3. **Anchor**: the data-aided preamble phase resolves the power-m
       branch (2pi/m grid) exactly once.
    4. **Parallel DD refine**: ``refine`` rounds of per-block decisions +
       one conj-product reduction, all blocks at once — the same math as
       one DD-scan body, vmapped over blocks instead of chained.

    Same signature/output contract as the DD scan. The engines differ in
    lock behavior at the waterfall's bottom (cycle-slip statistics), so the
    default router keeps DD unless measurement shows parity — see
    ModemConfig.tracker.
    """
    n = eq.shape[-1]
    nb = -(-n // block)
    pad = nb * block - n
    yr = jnp.pad(jnp.real(eq), (0, pad)).reshape(nb, block)
    yi = jnp.pad(jnp.imag(eq), (0, pad)).reshape(nb, block)
    kr = jnp.pad(known_r, (0, pad)).reshape(nb, block)
    ki = jnp.pad(known_i, (0, pad)).reshape(nb, block)
    km = jnp.pad(known_mask, (0, pad)).reshape(nb, block)
    vm = (jnp.arange(nb * block) < n).reshape(nb, block)

    m = 2 if bits_per_symbol == 1 else 4
    # y^m via repeated complex squaring (planar)
    zr, zi = yr, yi
    for _ in range(1 if m == 2 else 2):
        zr, zi = zr * zr - zi * zi, 2.0 * zr * zi
    zr = jnp.where(vm, zr, 0.0)
    zi = jnp.where(vm, zi, 0.0)
    br = jnp.sum(zr, axis=1)
    bi = jnp.sum(zi, axis=1)
    if smooth > 1:
        win = jnp.ones(smooth, jnp.float32)
        br = jnp.convolve(br, win, mode="same")
        bi = jnp.convolve(bi, win, mode="same")
    offset = float(np.pi) if m == 4 else 0.0
    theta = (jnp.arctan2(bi, br) - offset) / m  # phi mod 2pi/m, per block

    two_pi_m = 2.0 * float(np.pi) / m
    d = jnp.diff(theta)
    d = d - two_pi_m * jnp.round(d / two_pi_m)  # wrapped diffs
    unwr = theta[0] + jnp.concatenate(
        [jnp.zeros(1, theta.dtype), jnp.cumsum(d)]
    )

    # data-aided anchor over the (known & valid) preamble symbols
    use = (km & vm).astype(yr.dtype)
    da_re = jnp.sum((yr * kr + yi * ki) * use)
    da_im = jnp.sum((yi * kr - yr * ki) * use)
    phi_da = jnp.arctan2(da_im, da_re)
    branch = two_pi_m * jnp.round((phi_da - unwr[0]) / two_pi_m)
    phi = unwr + branch  # (nb,)

    for _ in range(refine):
        c = jnp.cos(phi)[:, None]
        s = jnp.sin(phi)[:, None]
        r1 = yr * c + yi * s
        i1 = yi * c - yr * s
        dr, di = _decide(r1, i1, bits_per_symbol)
        rr = jnp.where(km, kr, dr) * vm.astype(yr.dtype)
        ri = jnp.where(km, ki, di) * vm.astype(yr.dtype)
        e_re = jnp.sum(r1 * rr + i1 * ri, axis=1)
        e_im = jnp.sum(i1 * rr - r1 * ri, axis=1)
        phi = phi + jnp.arctan2(e_im, e_re)

    c = jnp.cos(phi)[:, None]
    s = jnp.sin(phi)[:, None]
    out_r = yr * c + yi * s
    out_i = yi * c - yr * s
    return jax.lax.complex(out_r.reshape(-1)[:n], out_i.reshape(-1)[:n])


@functools.partial(jax.jit, static_argnames=("cfg", "n_payload"))
def receive(
    cfg: ModemConfig, i: jax.Array, q: jax.Array, n_payload: int
) -> tuple[jax.Array, dict]:
    """Full jittable receive path: planar sps-rate (i, q) -> payload bits.

    Stages (each a batched reduction — no sample-serial tracking loops):
    matched filter -> Oerder-Meyr timing -> symbol-rate downsample ->
    coarse 4th-power CFO (at symbol rate, where the spectral line is
    strong) -> preamble-correlation frame sync -> data-aided phase-slope
    fine CFO -> ridge-LS equalizer trained on the preamble -> blockwise
    decision-directed phase tracking -> hard Gray decisions. Returns
    (bits, diagnostics); diag cfo_* entries are cycles/SYMBOL.
    """
    pre = preamble_symbols(cfg)
    p_len = cfg.preamble_len
    # complex constants form ON DEVICE from planar parts (complex64
    # transfers are unimplemented on some PJRT backends)
    pre_c = jax.lax.complex(
        jnp.asarray(pre.real, jnp.float32), jnp.asarray(pre.imag, jnp.float32)
    )
    power = 2 if cfg.bits_per_symbol == 1 else 4

    x = jax.lax.complex(i.astype(jnp.float32), q.astype(jnp.float32))
    # tail zeros so the causal matched filter and the symbol-grid reshape
    # cover the last symbol's peak plus the equalizer margin
    tail = cfg.rrc_num_taps + (cfg.eq_taps + 2) * cfg.sps
    x = jnp.concatenate([x, jnp.zeros(tail, x.dtype)])
    # the matched filter tolerates any in-capture-range CFO (the shift is
    # tiny against the RRC transition band) and |y|^2 timing is rotation-
    # invariant, so carrier recovery can wait until symbol rate
    y = _matched_filter(cfg, x)

    phase, tau = _oerder_meyr(y, cfg.sps)
    n_sym = y.shape[-1] // cfg.sps
    y2d = y[: n_sym * cfg.sps].reshape(n_sym, cfg.sps)
    r = jax.lax.dynamic_index_in_dim(y2d, phase, axis=1, keepdims=False)

    # coarse carrier at symbol rate (cycles/symbol)
    cfo_c = _coarse_cfo(r, power)
    n_k = jnp.arange(r.shape[-1]).astype(jnp.float32)
    rot = -2.0 * jnp.pi * cfo_c * n_k
    r = r * jax.lax.complex(jnp.cos(rot), jnp.sin(rot))

    start = _preamble_sync(r, pre)
    seg_len = p_len + n_payload
    half = cfg.eq_taps // 2
    ext_len = seg_len + 2 * half
    # slice WITH the equalizer's half-tap margin of real received samples
    # on both sides (zero-filled margins cost the edge symbols their
    # context), padded so the dynamic slice never clamps (a clamped start
    # would silently shift the frame)
    r_pad = jnp.concatenate(
        [jnp.zeros(half, r.dtype), r, jnp.zeros(ext_len, r.dtype)]
    )
    seg_ext = jax.lax.dynamic_slice(r_pad, (start,), (ext_len,))

    # fine CFO: Luise-Reggiannini multi-lag phase slope over the preamble.
    # The lag-1 estimator's noise floor (~1.4e-2 cycles/symbol at 7 dB)
    # poisons the derotation; summing autocorrelations R(1..P/2) of
    # v = r*conj(pre) gets within a few dB of the CRB, and the remaining
    # ramp is slow enough for the blockwise DD tracker. Capture range
    # |f| < 1/(M+1) cycles/symbol >> the coarse stage's half-bin residual.
    v = seg_ext[half : half + p_len] * jnp.conj(pre_c)
    m_lag = p_len // 2
    acc_re = jnp.float32(0.0)
    acc_im = jnp.float32(0.0)
    for m in range(1, m_lag + 1):
        rm = jnp.sum(v[m:] * jnp.conj(v[:-m]))
        acc_re = acc_re + jnp.real(rm)
        acc_im = acc_im + jnp.imag(rm)
    cfo_f = jnp.arctan2(acc_im, acc_re) / (jnp.pi * (m_lag + 1))  # cyc/symbol
    ks = (jnp.arange(ext_len) - half).astype(jnp.float32)
    rot_f = -2.0 * jnp.pi * cfo_f * ks
    seg_ext = seg_ext * jax.lax.complex(jnp.cos(rot_f), jnp.sin(rot_f))

    frames = _symbol_frames(seg_ext, seg_len, cfg.eq_taps)
    w = _ls_equalizer(frames[:p_len], pre_c, cfg.eq_ridge)
    eq = frames @ w

    known_r = jnp.pad(jnp.real(pre_c), (0, n_payload))
    known_i = jnp.pad(jnp.imag(pre_c), (0, n_payload))
    known_mask = jnp.arange(seg_len) < p_len
    if cfg.tracker == "vv":
        tracked = _vv_phase_track(
            eq,
            known_r,
            known_i,
            known_mask,
            cfg.bits_per_symbol,
            cfg.dd_block,
            cfg.vv_smooth,
            cfg.vv_refine,
        )
    else:
        tracked = _dd_phase_track(
            eq,
            known_r,
            known_i,
            known_mask,
            cfg.bits_per_symbol,
            cfg.dd_block,
            cfg.dd_unroll,
        )
    bits = demap_symbols(
        jnp.real(tracked[p_len:]), jnp.imag(tracked[p_len:]), cfg.bits_per_symbol
    )
    evm = jnp.sqrt(jnp.mean(jnp.abs(tracked[:p_len] - pre_c) ** 2))
    diag = {
        "cfo_coarse": cfo_c,
        "cfo_fine_per_symbol": cfo_f,
        "timing_phase": phase,
        "timing_tau": tau,
        "frame_start": start,
        "evm": evm,
    }
    return bits, diag
