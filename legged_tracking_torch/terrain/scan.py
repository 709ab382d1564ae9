"""Observation height scan: kernel B1 (``csrc/scan_heights.cu``), its plain
PyTorch version and its wrapper.

Port of the TPU kernel ``legged_tracking_tpu/terrain/pallas_scan.py``
(``scan_heights_pallas``).  For each env n and each of the P base-local scan
points: ``px = (grid_x + base_x) + cam_x``, ``lx = (px - origin_x) * inv_hs``
(likewise y), ``x0 = clip(trunc(lx), 0, h-2)``, ``y0 = clip(trunc(ly), 0,
w-2)`` and ``out[n, l, p] = tiles[env_tile[n], l, x0, y0]`` for l in
{ceiling, floor}.  ``inv_hs`` is the float32 reciprocal of the cell size:
the JAX package writes ``/ hs``, and XLA compiles that, in the Pallas kernel
and in the XLA scan alike, to a multiply by the reciprocal
(``heightfield.to_cells``).  The result is bitwise equal to both.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import KERNELS
from .heightfield import inv_hs, to_cells


def scan_cells(tiles, env_tile, frames, grid_pts, hs: float):
    """(N, P) int64: the flat index into ``tiles.reshape(-1)`` of the
    ceiling cell each scan point reads; its floor cell is ``h * w`` further.
    Arguments as for :func:`scan_heights_reference`."""
    T, L, h, w = tiles.shape
    px = (grid_pts[None, :, 0] + frames[:, 0, 0, None]) + frames[:, 1, 0, None]
    py = (grid_pts[None, :, 1] + frames[:, 0, 1, None]) + frames[:, 1, 1, None]
    lx = to_cells(px - frames[:, 2, 0, None], hs)                    # (N, P)
    ly = to_cells(py - frames[:, 2, 1, None], hs)
    x0 = torch.clamp(lx.to(torch.int32), 0, h - 2).long()
    y0 = torch.clamp(ly.to(torch.int32), 0, w - 2).long()
    return env_tile.long()[:, None] * (L * h * w) + x0 * w + y0


def scan_heights_reference(tiles, env_tile, frames, grid_pts, hs: float):
    """Plain PyTorch version of kernel B1, the same arithmetic in the same
    order.  tiles (T, 2, h, w) bf16; env_tile (N,) int32; frames (N, 3, 2) f32
    [base_xy, camera shift, terrain origin]; grid_pts (P, 2) f32.  Returns
    (N, 2, P) f32 [ceiling, floor]."""
    h, w = tiles.shape[2:]
    cell = scan_cells(tiles, env_tile, frames, grid_pts, hs)
    flat = tiles.reshape(-1)
    return torch.stack([flat[cell], flat[cell + h * w]], dim=1).float()


def scan_heights(tiles, env_tile, frames, grid_pts, hs: float):
    """Kernel B1 on a CUDA tensor, its plain version on a CPU tensor.

    On the card it launches the kernel or raises; ``scan_heights.launches``
    counts the launches."""
    if tiles.device.type == "cpu":
        return scan_heights_reference(tiles, env_tile, frames, grid_pts, hs)
    if tiles.device.type != "cuda":
        raise ValueError(f"scan_heights: unsupported device {tiles.device}")
    T, L, h, w = tiles.shape
    N, P = env_tile.shape[0], grid_pts.shape[0]
    for name, t, dtype, shape in (("tiles", tiles, torch.bfloat16, (T, 2, h, w)),
                                  ("env_tile", env_tile, torch.int32, (N,)),
                                  ("frames", frames, torch.float32, (N, 3, 2)),
                                  ("grid_pts", grid_pts, torch.float32, (P, 2))):
        if t.device != tiles.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"scan_heights: {name} must be a contiguous {dtype} tensor "
                             f"of shape {shape} on {tiles.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if h < 2 or w < 2:
        raise ValueError(f"scan_heights: tiles of {h}x{w} cells")
    lib = KERNELS.get("scan_heights")
    fn = lib.scan_heights
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((N, 2, P), dtype=torch.float32, device=tiles.device)
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        err = fn(tiles.data_ptr(), env_tile.data_ptr(), frames.data_ptr(), grid_pts.data_ptr(),
                 out.data_ptr(), N, P, h, w, inv_hs(hs), stream)
    if err != 0:
        raise RuntimeError(f"scan_heights: kernel launch failed with CUDA error {err}")
    scan_heights.launches += 1
    return out


scan_heights.launches = 0
