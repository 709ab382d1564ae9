"""Observation height scan: kernel B1 (``csrc/scan_heights.cu``), its plain
PyTorch version, its launch shape and its wrapper.

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
import functools

import torch

from ..utils.cuda_build import KERNELS
from .heightfield import inv_hs, to_cells

# the kernel's block: its threads, the most envs it takes (one tile index
# a thread), and the blocks per SM its __launch_bounds__ leaves registers
# for (csrc/scan_heights.cu kThreads, kResident)
THREADS = 256
RESIDENT = 4
# shared memory of an sm_90 SM, the most one block may opt in to, and the
# runtime's own share of each block (CUDA programming guide, compute 9.0)
SMEM_SM = 233_472
SMEM_BLOCK = 232_448
SMEM_RESERVED = 1_024


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


def staging_bytes(E: int, P: int) -> int:
    """Dynamic shared memory of a block of E envs: its output span (E, 2, P)
    f32, E tile pointers, E frames (3, 2) f32 and the grid (P, 2) f32."""
    return 8 * E * P + 8 * E + 24 * E + 8 * P


@functools.lru_cache(maxsize=256)
def launch_shape(N: int, P: int, sm_count: int) -> tuple[int, int, int]:
    """(E, blocks, shared memory bytes) of kernel B1 for N envs, P points.

    E, the envs of a block, is even, so that a block's output span is a
    multiple of 16 bytes at a 16-byte-aligned offset (the bulk store's
    rule).  It is the smallest even E with which the ``ceil(N / E)`` blocks
    fit one wave of ``RESIDENT`` blocks on each of ``sm_count`` SMs, but no
    larger than shared memory lets ``RESIDENT`` blocks share an SM; past
    that the grid runs in more waves.  Above 48 KB the kernel opts in to
    more shared memory; a grid whose staging does not fit one block even
    at E = 2 (P above 9,682) is refused."""
    if N < 1 or P < 1 or sm_count < 1:
        raise ValueError(f"scan_heights: no launch for N={N}, P={P}, {sm_count} SMs")
    if staging_bytes(2, P) > SMEM_BLOCK:
        raise ValueError(f"scan_heights: a grid of {P} points does not fit a block's "
                         f"{SMEM_BLOCK} bytes of shared memory")
    per_block = SMEM_SM // RESIDENT - SMEM_RESERVED
    e_max = min(THREADS, max(2, (per_block - 8 * P) // (8 * P + 32) // 2 * 2))
    per_wave = -(-N // (sm_count * RESIDENT))       # envs a block takes in one wave
    E = min(e_max, max(2, per_wave + per_wave % 2))
    return E, -(-N // E), staging_bytes(E, P)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The ctypes entry of the built kernel, its signature set once."""
    fn = KERNELS.get("scan_heights").scan_heights
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(tiles, env_tile, frames, grid_pts, hs: float, shape):
    """Kernel B1 on checked CUDA tensors with launch ``shape`` = (E, blocks,
    smem); raises on a CUDA error.  Counts nothing."""
    N, P = env_tile.shape[0], grid_pts.shape[0]
    h, w = tiles.shape[2], tiles.shape[3]
    index = tiles.get_device()
    out = torch.empty((N, 2, P), dtype=torch.float32, device=tiles.device)
    # the current stream's handle, as torch.cuda.current_stream(index)
    # .cuda_stream gives it, without building a Stream object
    err = _kernel()(tiles.data_ptr(), env_tile.data_ptr(), frames.data_ptr(),
                    grid_pts.data_ptr(), out.data_ptr(), N, P, h, w, inv_hs(hs), *shape,
                    index, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"scan_heights: kernel launch failed with CUDA error {err}")
    return out


def scan_heights(tiles, env_tile, frames, grid_pts, hs: float):
    """Kernel B1 on a CUDA tensor, its plain version on a CPU tensor.

    On the card it launches the kernel or raises; ``scan_heights.launches``
    counts the launches."""
    if not tiles.is_cuda:
        if tiles.device.type == "cpu":
            return scan_heights_reference(tiles, env_tile, frames, grid_pts, hs)
        raise ValueError(f"scan_heights: unsupported device {tiles.device}")
    T, L, h, w = tiles.shape
    N, P = env_tile.shape[0], grid_pts.shape[0]
    index = tiles.get_device()
    shapes_ok = (L == 2 and env_tile.dim() == 1 and frames.shape == (N, 3, 2)
                 and grid_pts.shape == (P, 2) and 2 <= h < 2 ** 23 and 2 <= w < 2 ** 23
                 and h * w < 2 ** 31)
    if not shapes_ok \
            or (tiles.dtype, env_tile.dtype, frames.dtype, grid_pts.dtype) != _DTYPES \
            or (env_tile.get_device(), frames.get_device(), grid_pts.get_device()) \
            != (index, index, index) \
            or not (tiles.is_contiguous() and env_tile.is_contiguous()
                    and frames.is_contiguous() and grid_pts.is_contiguous()):
        raise ValueError(
            "scan_heights: needs contiguous tiles (T, 2, h, w) bf16 with 2 <= h, w < 2^23 "
            "and h * w < 2^31, env_tile (N,) int32, frames (N, 3, 2) f32 and grid_pts "
            "(P, 2) f32 on one card; got "
            + ", ".join(f"{t.dtype} {tuple(t.shape)} on {t.device}"
                        for t in (tiles, env_tile, frames, grid_pts)))
    if N == 0 or P == 0:
        return torch.empty((N, 2, P), dtype=torch.float32, device=tiles.device)
    out = _launch(tiles, env_tile, frames, grid_pts, hs, launch_shape(N, P, _sm_count(index)))
    scan_heights.launches += 1
    return out


_DTYPES = (torch.bfloat16, torch.int32, torch.float32, torch.float32)
scan_heights.launches = 0
