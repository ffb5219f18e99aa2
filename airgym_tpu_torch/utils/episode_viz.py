"""Headless episode visualization for ``--play --record_dir`` and the
runner's ``config.viz_every_epochs`` dumps (counterpart of
airgym_tpu/utils/episode_viz.py).

``dump_episode`` writes, from a Player recording (numpy arrays on the
host):
  * ``episode.npz``    - the raw recorded arrays, written first;
  * ``trajectory.png`` - xy path, altitude, attitude, speed, reward and
    finished episodes of the recorded envs;
  * ``depth.gif``      - the depth-camera stream of env 0 (camera tasks).
matplotlib and PIL are imported inside the function only: a machine
without them can still import this module, and ``episode.npz`` is
written before either is needed.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np


def _euler_from_quat(q: np.ndarray) -> np.ndarray:
    """xyzw quaternion [.., 4] -> roll / pitch / yaw [.., 3]."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1, 1))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.stack([roll, pitch, yaw], axis=-1)


def dump_episode(out_dir: str, record: Dict[str, np.ndarray],
                 gif_stride: int = 2, gif_max_frames: int = 400) -> None:
    """record: "root" [T, K, 13], "reward" [T, >= K], "reset" [T, >= K],
    optional "camera" [T, W, H] (env 0's image, plotted as it is)."""
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(out_dir, "episode.npz"), **record)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    root = record["root"]
    rew = record["reward"][:, : root.shape[1]]
    t = np.arange(root.shape[0])
    eul = _euler_from_quat(root[..., 3:7])

    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    ax = axes[0, 0]
    for k in range(root.shape[1]):
        ax.plot(root[:, k, 0], root[:, k, 1], lw=1)
        ax.plot(root[0, k, 0], root[0, k, 1], "go", ms=4)
        ax.plot(root[-1, k, 0], root[-1, k, 1], "rx", ms=6)
    ax.set_title("xy path (o start, x end)")
    ax.set_aspect("equal", adjustable="datalim")
    axes[0, 1].plot(t, root[:, :, 2])
    axes[0, 1].set_title("altitude z [m]")
    for i, name in enumerate(("roll", "pitch", "yaw")):
        axes[0, 2].plot(t, eul[:, 0, i], label=name)
    axes[0, 2].legend(fontsize=8)
    axes[0, 2].set_title("attitude env0 [rad]")
    axes[1, 0].plot(t, np.linalg.norm(root[:, :, 7:10], axis=-1))
    axes[1, 0].set_title("|velocity| [m/s]")
    axes[1, 1].plot(t, rew)
    axes[1, 1].set_title("reward/step")
    resets = record.get("reset")
    if resets is not None:
        axes[1, 2].plot(t, np.cumsum(resets[:, 0]))
        axes[1, 2].set_title("episodes finished (env0)")
    for a in axes.flat:
        a.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "trajectory.png"), dpi=110)
    plt.close(fig)

    cam = record.get("camera")
    if cam is not None and cam.size:
        from PIL import Image
        frames = cam[::gif_stride][:gif_max_frames]      # [F, W, H]
        lo, hi = float(np.min(frames)), float(np.max(frames))
        scale = 255.0 / (hi - lo + 1e-9)
        # [W, H] -> [H, W] on screen; a 2-d uint8 array is mode "L"
        imgs = [Image.fromarray(((f.T - lo) * scale).astype(np.uint8))
                .resize((f.shape[0] * 2, f.shape[1] * 2), Image.NEAREST)
                for f in frames]
        imgs[0].save(os.path.join(out_dir, "depth.gif"), save_all=True,
                     append_images=imgs[1:], duration=50, loop=0)
