"""Host-side visualization (headless-friendly; port of
``libwave_tpu.viz``).

Parity with the reference's viz components, which are compiled but disabled
in its CI for lack of a display (SURVEY.md §4):

- ``PointCloudDisplay`` (wave_matching/include/wave/matching/
  pointcloud_display.hpp:31: a PCLVisualizer on a worker thread with queued
  addPointcloud/addLine calls) -> :class:`PointCloudDisplay`, a worker
  thread that renders queued clouds/lines to PNG files with matplotlib —
  device work never blocks on drawing;
- ``Tracker::drawTracks`` (wave_vision tracker.hpp) -> :func:`draw_tracks`,
  feature tracks overlaid on an image.

All functions degrade to no-ops if matplotlib is unavailable. It is
imported at first use, not when this module is imported.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without
    matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class PointCloudDisplay:
    """Queued, threaded point-cloud renderer writing PNG frames.

    >>> disp = PointCloudDisplay("viz_out")
    >>> disp.add_pointcloud(points, cloud_id=0)
    >>> disp.add_line(p1, p2)
    >>> disp.render()     # enqueue a frame
    >>> disp.stop()       # join worker (reference: stopSpin)
    """

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._queue: "queue.Queue" = queue.Queue()
        self._clouds = {}
        self._lines = []
        self._frame = 0
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._spin, daemon=True)
        self._worker.start()

    def add_pointcloud(self, points, cloud_id: int = 0) -> None:
        self._clouds[cloud_id] = _host(points)

    def add_line(self, p1, p2) -> None:
        self._lines.append((_host(p1), _host(p2)))

    def render(self) -> None:
        self._queue.put((dict(self._clouds), list(self._lines), self._frame))
        self._frame += 1

    def _spin(self) -> None:
        while not self._stop.is_set() or not self._queue.empty():
            try:
                clouds, lines, frame = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            plt = _pyplot()
            if plt is None:
                continue
            fig = plt.figure(figsize=(8, 8))
            ax = fig.add_subplot(111, projection="3d")
            for cid, pts in clouds.items():
                ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.5,
                           label=f"cloud {cid}")
            for p1, p2 in lines:
                ax.plot([p1[0], p2[0]], [p1[1], p2[1]], [p1[2], p2[2]],
                        "r-", linewidth=0.8)
            ax.legend(loc="upper right", fontsize=6)
            fig.savefig(os.path.join(self.out_dir, f"frame_{frame:05d}.png"),
                        dpi=90)
            plt.close(fig)

    def stop(self) -> None:
        self._stop.set()
        self._worker.join(timeout=30)


def draw_tracks(image, xy_per_frame, mask_per_frame, out_path: str) -> None:
    """Overlay feature tracks on an image (drawTracks parity).

    ``xy_per_frame``: list of (N, 2) arrays (oldest first);
    ``mask_per_frame``: matching validity masks. Tracks are drawn as
    polylines ending at the newest frame's keypoints.
    """
    plt = _pyplot()
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(10, 7))
    ax.imshow(_host(image), cmap="gray")
    T = len(xy_per_frame)
    for i in range(_host(xy_per_frame[0]).shape[0]):
        xs, ys = [], []
        for t in range(T):
            if bool(_host(mask_per_frame[t])[i]):
                pt = _host(xy_per_frame[t])[i]
                xs.append(pt[0])
                ys.append(pt[1])
        if len(xs) >= 2:
            ax.plot(xs, ys, "-", linewidth=0.8)
        if xs:
            ax.plot(xs[-1], ys[-1], "g.", markersize=3)
    ax.set_axis_off()
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
