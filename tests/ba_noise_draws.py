"""The gtsam offline example's bounds over noise draws (not collected by
pytest): the reference test's dataset (``tests/test_ba.py``) with 1.1 px
noise and first-two-pose priors, landmarks offset by (-0.25, 0.20, 0.15),
30 LM iterations at f64, solved by the JAX package for ``jax.random.key(s)``
and by the port for ``torch.Generator().manual_seed(s)``, s = 0..7. Prints
each draw's worst position and rotation error, the landmark error's mean
and 85th percentile, and whether all four bounds (0.1 m, 0.05 rad, 1.5 m,
2 m) hold.

    JAX_PLATFORMS=cpu python tests/ba_noise_draws.py   # ~1 min
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from libwave_tpu.geometry import so3 as jso3
from libwave_tpu.optim import ba as jba
from libwave_tpu.sim import VoSimParams, generate_vo_dataset
from libwave_tpu_torch import interop
from libwave_tpu_torch.geometry import so3 as tso3
from libwave_tpu_torch.optim import ba as tba

OFFSET = (-0.25, 0.20, 0.15)


def _row(pos, rot, lm):
    q85 = float(np.quantile(lm, 0.85))
    ok = pos < 0.1 and rot < 0.05 and lm.mean() < 1.5 and q85 < 2.0
    return f"pos {pos:.4f} rot {rot:.4f} lm mean {lm.mean():.3f} q85 {q85:.3f} {'meets' if ok else 'misses'}"


def main():
    jax.config.update("jax_enable_x64", True)
    dj = generate_vo_dataset(VoSimParams(nb_landmarks=100, steps=300,
                                         fx=200.0, fy=200.0, hz=10.0),
                             jax.random.key(7))
    dt = interop.vo_dataset_from_jax_numpy(jax.tree.map(np.asarray, dj),
                                           device="cpu")
    solve = jax.jit(lambda p, s: jba.solve_ba(p, s,
                                              jba.BAConfig(max_iterations=30)))
    for seed in range(8):
        pj, gj = jba.ba_from_dataset(dj, noise_pixels=1.1,
                                     key=jax.random.key(seed),
                                     with_priors=True)
        oj, _ = solve(pj, gj._replace(lm=gj.lm + jnp.asarray(OFFSET)))
        pt, gt = tba.ba_from_dataset(
            dt, noise_pixels=1.1, generator=torch.Generator().manual_seed(seed),
            with_priors=True, device="cpu")
        ot, _ = tba.solve_ba(pt, gt._replace(lm=gt.lm + torch.tensor(
            OFFSET, dtype=torch.float64)), tba.BAConfig(max_iterations=30))
        jrow = _row(float(jnp.max(jnp.linalg.norm(oj.p - gj.p, axis=-1))),
                    float(jnp.max(jso3.rotation_distance(oj.q, gj.q))),
                    np.linalg.norm(np.asarray(oj.lm - gj.lm), axis=-1))
        trow = _row((ot.p - gt.p).norm(dim=-1).max().item(),
                    tso3.rotation_distance(ot.q, gt.q).max().item(),
                    (ot.lm - gt.lm).norm(dim=-1).numpy())
        print(f"draw {seed}: JAX key {jrow} | port generator {trow}")


if __name__ == "__main__":
    main()
