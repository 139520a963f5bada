"""The JAX package's figures on ``bench_trajectory``'s GPS/INS smoother:
the anchor of ``chip_smoke.py``'s gps_trajectory phase.

    JAX_PLATFORMS=cpu python tests/trajectory_anchors.py

builds the smoother's problem from ``bench_trajectory.gps_truth()`` (200
states at 10 Hz, seed 0) and the LLH fixes ``bench_trajectory.gps_fixes``
writes, through the JAX package's own ``enu_point_from_llh``,
``MeasurementBuffer`` (``insert_batch``, ``get_interpolated`` under
``jax.vmap``) and factor banks, solves it with its
``solve_trajectory_gn`` (25 iterations, f64, under ``jax.jit``) on the
CPU, and prints one JSON line: the initial and final cost, the
cost trace, and the worst position and bias errors against the truth.

Not collected by pytest (no ``test_`` prefix); the CPU parity test
``tests/test_torch_factors.py`` imports :func:`jax_gps_enu` and
:func:`jax_gps_problem` from it.
About a minute on a CPU.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from libwave_tpu.containers import measurement as jm  # noqa: E402
from libwave_tpu.geography import world_frame as jwf  # noqa: E402
from libwave_tpu.geometry.se3 import SE3 as JSE3  # noqa: E402
from libwave_tpu.optim import factors as jf  # noqa: E402
from libwave_tpu.optim.states import PoseVelBiasState as JState  # noqa: E402
from libwave_tpu_torch import bench_trajectory as bt  # noqa: E402


def jax_gps_enu(llh):
    """The fixes' LLH in ENU about the datum, by the JAX package
    (``bench_trajectory.gps_fixes_enu``'s steps; the conversion cancels to
    about 1e-9 m: ECEF coordinates are ~6.4e6 m)."""
    return jwf.enu_point_from_llh(jnp.asarray(llh), jnp.asarray(bt.DATUM_LLH))


def jax_gps_problem(truth, enu):
    """The JAX package's (state0, residual_fns, ok) for the smoother from
    the fixes' ENU (T, 3): the same steps as
    ``bench_trajectory.gps_problem``."""
    enu = jnp.asarray(enu)
    T = enu.shape[0]
    times, q = jnp.asarray(truth["times"]), jnp.asarray(truth["q"])
    buf = jm.measurement_buffer(T, 7, jnp.float64)
    buf = jm.insert_batch(buf, times, jnp.full((T,), bt.GPS_SENSOR,
                                               jnp.int32),
                          jnp.concatenate([enu, q], axis=-1))
    fix, ok = jax.vmap(jm.get_interpolated, (None, 0, None))(
        buf, times, bt.GPS_SENSOR)
    T_meas = JSE3(q=fix[:, 3:7], t=fix[:, 0:3])
    p, vel = jnp.asarray(truth["p"]), jnp.asarray(truth["vel"])
    state0 = JState(q=q, p=p + bt.GPS_OFFSET_M, vel=vel,
                    bias=jnp.zeros_like(p))
    prior = JSE3(q=q[:1], t=p[:1])
    i = jnp.arange(T)
    a, b = i[:-1], i[1:]
    dts = jnp.full((T - 1,), bt.GPS_DT)
    fns = [
        lambda s: jf.gps_residual(s, i, T_meas),
        lambda s: jf.motion_residual(s, a, b, dts),
        lambda s: jf.decaying_bias_residual(s, a, b, dts, bt.BIAS_TAU,
                                            bt.BIAS_SQRT_INFO),
        lambda s: jf.pose_prior_residual(s, i[:1], prior),
        lambda s: jf.twist_prior_residual(s, i[:1], vel[:1]),
    ]
    return state0, fns, ok


def main():
    jax.config.update("jax_enable_x64", True)
    truth = bt.gps_truth()
    state0, fns, ok = jax_gps_problem(truth, jax_gps_enu(bt.gps_fixes(truth)))
    assert bool(np.asarray(ok).all())
    solve = jax.jit(lambda s: jf.solve_trajectory_gn(s, fns,
                                                     num_iters=bt.GPS_ITERS))
    out, info = solve(state0)
    p, b = np.asarray(out.p), np.asarray(out.bias)
    print(json.dumps({
        "states": int(p.shape[0]),
        "initial_cost": float(info["initial_cost"]),
        "final_cost": float(info["final_cost"]),
        "costs": [float(c) for c in np.asarray(info["costs"])],
        "position_m": float(np.abs(p - truth["p"]).max()),
        "bias_m": float(np.abs(b - truth["bias"]).max()),
    }))


if __name__ == "__main__":
    main()
