"""Problems for the distributed layer's checks (``chip_smoke.py``'s
distributed phases and the CPU tests).

:func:`circle_graph` is the pose graph of the JAX package's
``tests/test_dist_pose_graph.py`` at any size: a circle of ``n`` poses with
noisy odometry and ground-truth loop closures of every kind the block
partition must handle at 2 and 4 blocks (a closure onto the previous
block, long-range closures through separators, the end-to-start wrap, two
closures in opposite directions between the same blocks, two closures onto
one separator), from a perturbed start with pose 0 exact. Noise comes
from a numpy generator, so the CPU tests hand the same arrays to both
packages.
"""

from __future__ import annotations

import numpy as np
import torch

from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.optim.pose_graph import BetweenBank


def circle_closures(n: int):
    """(i, j) loop-closure pairs of :func:`circle_graph` at ``n`` poses."""
    b2, b4 = -(-n // 2), 2 * -(-n // 4)  # block starts at 2 and 4 blocks
    return [
        (b2, b2 - 1), (b4, b4 - 1),  # onto the previous block
        (n // 20, n * 4 // 5), (n // 12, n * 4 // 5),  # one separator, twice
        (n // 6, n * 3 // 5),  # long range
        (n - 7, 2),  # end-to-start wrap
        (n // 7, n * 3 // 4), (n * 3 // 4, n // 7),  # both directions
    ]


def _relative(q, p, i, j):
    qi_inv = so3.quat_inverse(q[i])
    return so3.quat_multiply(qi_inv, q[j]), so3.quat_rotate(qi_inv,
                                                            p[j] - p[i])


def circle_graph(n: int, seed: int = 3, device="cpu"):
    """(q, p) ground truth, (q0, p0) perturbed start and the BetweenBank
    (odometry, sigmas 1e-3, noisy; closures, sigmas 1e-2, exact) of the
    circle at ``n`` poses, f64 on ``device``."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
    p = np.stack([10 * np.cos(theta), 10 * np.sin(theta),
                  0.1 * np.sin(3 * theta)], axis=-1)
    yaw = theta + np.pi / 2
    q = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], -1)
    q, p = torch.as_tensor(q), torch.as_tensor(p)

    i = torch.arange(n - 1)
    dq, dp = _relative(q, p, i, i + 1)
    dq = so3.quat_boxplus(dq, 1e-3 * torch.as_tensor(
        rng.standard_normal((n - 1, 3))))
    dp = dp + 1e-3 * torch.as_tensor(rng.standard_normal((n - 1, 3)))
    ci, cj = (torch.as_tensor(x) for x in zip(*circle_closures(n)))
    cq, cp = _relative(q, p, ci, cj)
    si = torch.cat([torch.full((n - 1, 6), 1e3, dtype=torch.float64),
                    torch.full((len(ci), 6), 1e2, dtype=torch.float64)])
    between = BetweenBank(
        i=torch.cat([i, ci]).to(torch.int32),
        j=torch.cat([i + 1, cj]).to(torch.int32),
        dq=torch.cat([dq, cq]), dp=torch.cat([dp, cp]), sqrt_info=si)

    mask = np.ones((n, 1))
    mask[0] = 0.0
    q0 = so3.quat_boxplus(q, torch.as_tensor(
        0.03 * rng.standard_normal((n, 3)) * mask))
    p0 = p + torch.as_tensor(0.1 * rng.standard_normal((n, 3)) * mask)
    move = lambda x: x.to(device)  # noqa: E731
    return (move(q), move(p), move(q0), move(p0),
            BetweenBank(*(move(x) for x in between)))


def pp_frames(windows: int = 8, device="cpu", size=(480, 640)):
    """``bench.py``'s ``bench_pp_overlap`` windows: each a blob image (seed
    = window index), its (4, 7) roll and the window's seed."""
    from libwave_tpu_torch.bench_frontend import blob_image

    frames = []
    for i in range(windows):
        img = blob_image(np.random.default_rng(i), H=size[0], W=size[1])
        frames.append((torch.as_tensor(img, device=device),
                       torch.as_tensor(np.roll(img, (4, 7), axis=(0, 1)),
                                       device=device), i))
    return frames


def pp_stages(num_features: int = 512, num_hypotheses: int = 2048):
    """``bench.py``'s ``bench_pp_overlap`` stages: the front end (FAST +
    BRISK on both images, top-2 Hamming match without outlier removal) and
    the back end (RANSAC fundamental matrix, essential matrix, pose).
    Returns (frontend, backend); the back end returns the unit
    translation. Random draws come from generators seeded by the window."""
    from libwave_tpu_torch.vision.descriptor import brisk_describe
    from libwave_tpu_torch.vision.detector import FASTParams, detect_fast
    from libwave_tpu_torch.vision.epipolar import (
        essential_from_fundamental,
        recover_pose,
    )
    from libwave_tpu_torch.vision.matcher import (
        MatcherParams,
        find_fundamental_ransac,
        match_descriptors,
    )

    fast_p = FASTParams(num_features=num_features)
    m_p = MatcherParams(auto_remove_outliers=False)

    def frontend(frame):
        a, b, seed = frame
        xy1, _, m1 = detect_fast(a, fast_p)
        xy2, _, m2 = detect_fast(b, fast_p)
        d1, _ = brisk_describe(a, xy1, m1)
        d2, _ = brisk_describe(b, xy2, m2)
        gen = torch.Generator(device=a.device).manual_seed(seed)
        idx2, valid, _ = match_descriptors(d1, d2, xy1, xy2, m1, m2, gen,
                                           m_p)
        return (xy1.to(torch.float32), xy2[idx2].to(torch.float32), valid,
                seed)

    def backend(feats):
        p1, p2, valid, seed = feats
        K = torch.tensor([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]],
                         dtype=torch.float32, device=p1.device)
        gen = torch.Generator(device=p1.device).manual_seed(seed)
        F, inl = find_fundamental_ransac(p1, p2, valid, gen, reproj_px=2.0,
                                         num_hypotheses=num_hypotheses)
        T, _, _ = recover_pose(essential_from_fundamental(F, K), p1, p2, K,
                               inl)
        return T.t

    return frontend, backend
