"""Offline video rendering from recorded env states (port of ``io/render.py``).

The reference records via Isaac Gym camera sensors
(legged_robot_trajectory_tracking.py:1666-1806, _render_headless).  Here a
rollout's kinematic frames are recorded on the device and rendered offline
with matplotlib: a terrain heightfield slice with the robot's base, side and
top views, written to mp4 (OpenCV) or GIF (PIL).  matplotlib, OpenCV and PIL
are imported inside the functions that draw or write.
"""

from __future__ import annotations

import numpy as np
import torch

def record_rollout(env, policy, steps: int, env_ids=(0,)):
    """Roll the stateful env with a policy, recording the kinematic frames
    and rewards of ``env_ids``.  The frames stay on the device and are
    copied to the host once, after the last step.  Returns a list of
    ``steps`` dicts of numpy arrays (base_pos, base_quat, qj, rew)."""
    ids = torch.as_tensor(list(env_ids), device=env.device)
    rec = {k: [] for k in ("base_pos", "base_quat", "qj", "rew")}
    obs = env.observe(env.state)
    for _ in range(steps):
        actions = policy(obs["obs"], obs["obs_history"])
        obs, rew, done, info = env.step(actions)
        phys = env.state.phys
        for k, x in zip(rec, (phys.base_pos, phys.base_quat, phys.qj, rew)):
            rec[k].append(x)
    if not steps:
        return []
    host = {k: torch.stack(v)[:, ids].cpu().numpy() for k, v in rec.items()}
    return [{k: v[t] for k, v in host.items()} for t in range(steps)]


def render_frames(frames, terrain, env_id_pos: int = 0, tile_idx: int = 0,
                  width_px: int = 360, height_px: int = 240):
    """Render recorded frames -> list of (H, W, 3) uint8 arrays.

    ``terrain`` is the port's TerrainArrays: its float32 tiles, as the JAX
    env's TerrainArrays holds them (the bfloat16 copy feeds the samplers
    only)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ceil, floor = terrain.tiles[tile_idx].cpu().numpy()
    hs = terrain.horizontal_scale
    origin = terrain.env_terrain_origin[env_id_pos].cpu().numpy()

    imgs = []
    xs_base = np.array([f["base_pos"][env_id_pos] for f in frames])
    for i, f in enumerate(frames):
        fig, (ax1, ax2) = plt.subplots(
            2, 1, figsize=(width_px / 72, height_px / 72), dpi=72)
        bp = f["base_pos"][env_id_pos]
        # side view: terrain slice along the robot's y row
        yi = int(np.clip((bp[1] - origin[1]) / hs, 0, floor.shape[1] - 1))
        xg = origin[0] + np.arange(floor.shape[0]) * hs
        ax1.plot(xg, floor[:, yi], "k-", lw=1)
        ax1.plot(xg, ceil[:, yi], "b-", lw=1, alpha=0.6)
        ax1.plot(bp[0], bp[2], "ro", ms=5)
        ax1.plot(xs_base[: i + 1, 0], xs_base[: i + 1, 2], "r-", lw=0.5, alpha=0.5)
        ax1.set_ylim(-0.1, 1.2)
        ax1.set_ylabel("z [m]")
        # top view
        ax2.imshow((ceil - floor).T, origin="lower", aspect="auto", cmap="viridis",
                   extent=[origin[0], origin[0] + floor.shape[0] * hs,
                           origin[1], origin[1] + floor.shape[1] * hs])
        ax2.plot(bp[0], bp[1], "ro", ms=4)
        ax2.set_xlabel("x [m]")
        fig.tight_layout()
        fig.canvas.draw()
        img = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
        img = img.reshape(fig.canvas.get_width_height()[::-1] + (4,))[..., :3]
        imgs.append(img.copy())
        plt.close(fig)
    return imgs


def write_mp4(imgs, path: str, fps: int = 50):
    """Write frames to mp4 via OpenCV (no ffmpeg plugin needed); falls back
    to GIF if no mp4 codec is available.  Returns the path written."""
    try:
        import cv2
        h, w = imgs[0].shape[:2]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not vw.isOpened():
            raise RuntimeError("no mp4 codec")
        for img in imgs:
            vw.write(cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        vw.release()
        return path
    except Exception:
        from PIL import Image
        gif = path.rsplit(".", 1)[0] + ".gif"
        frames = [Image.fromarray(i) for i in imgs]
        frames[0].save(gif, save_all=True, append_images=frames[1:],
                       duration=int(1000 / fps), loop=0)
        return gif
