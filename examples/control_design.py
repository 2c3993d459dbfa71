"""Control-loop design on the LTI surface: model, place poles, simulate.

A mass-spring-damper is stabilized by full-state feedback: pole
placement computes the gain, the continuous loop is validated with
lsim/step, then the controller is DISCRETIZED and re-validated as the
digital loop a DSP deployment would ship.

Runs on CPU or GPU:  python examples/control_design.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from digital_signal_processsing_tpu.ops import lti


def main() -> None:
    # plant: x'' = -0.2 x' - x + u  (lightly damped oscillator)
    A = np.array([[0.0, 1.0], [-1.0, -0.2]])
    B = np.array([[0.0], [1.0]])
    C = np.array([[1.0, 0.0]])
    D = np.array([[0.0]])

    # open loop rings for a long time
    T = np.linspace(0, 30, 1501)
    _, y_open = lti.step((A, B, C, D), T=T)
    settle_open = T[np.nonzero(np.abs(np.asarray(y_open) - 1.0) > 0.05)[0][-1]]

    # place closed-loop poles at -2 +- 1j: fast, damped
    res = lti.place_poles(A, B, np.array([-2.0 + 1j, -2.0 - 1j]))
    K = res.gain_matrix
    Acl = A - B @ K
    print(f"gain K = {K.ravel()}, placed poles {np.round(res.computed_poles, 3)}")

    # closed loop with reference scaling for unit DC gain
    dc = float((C @ np.linalg.solve(-Acl, B))[0, 0])
    Bcl = B / dc
    _, y_closed = lti.step((Acl, Bcl, C, D), T=T)
    y_closed = np.asarray(y_closed)
    settle_closed = T[
        np.nonzero(np.abs(y_closed - 1.0) > 0.05)[0][-1]
    ]
    print(
        f"5% settling: open {settle_open:.1f}s -> closed {settle_closed:.1f}s"
    )
    assert settle_closed < 0.2 * settle_open
    assert abs(y_closed[-1] - 1.0) < 0.01

    # ship it digital: discretize at 20 Hz and verify the digital loop
    Ad, Bd, Cd, Dd, dt = lti.cont2discrete((Acl, Bcl, C, D), 0.05, "zoh")
    _, yd = lti.dstep((Ad, Bd, Cd, Dd, dt), 600)
    yd = np.asarray(yd)[:, 0]
    cont = np.interp(np.arange(600) * dt, T, y_closed)
    print(f"digital-vs-continuous step max dev: {np.max(np.abs(yd - cont)):.4f}")
    assert np.max(np.abs(yd - cont)) < 0.01

    # disturbance rejection with lsim
    U = np.zeros_like(T)
    U[500:520] = 5.0  # impulse-ish kick
    _, y_dist, _ = lti.lsim((Acl, Bcl, C, D), U, T)
    y_dist = np.asarray(y_dist)
    print(f"kick recovered to <0.05 in {T[np.nonzero(np.abs(y_dist) > 0.05)[0][-1]] - 10:.1f}s")
    assert np.all(np.abs(y_dist[int(1500*14/30):]) < 0.05)

    print("control design OK")


if __name__ == "__main__":
    main()
