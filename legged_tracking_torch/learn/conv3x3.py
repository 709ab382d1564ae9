"""The height encoder's 3x3 convolutions, with kernel W1
(``csrc/conv3x3_wgrad.cu``) for their weight and bias gradients: its plain
PyTorch version, its wrapper and the autograd Function.

:func:`conv3x3` is ``F.conv2d(x, weight, bias, padding=1)``: the forward
is that call, and so is the input gradient (the same cuDNN backward-data
call autograd makes for it).  Only the weight and bias gradients come from
:func:`conv3x3_wgrad`: W1 on a CUDA tensor, the plain version on a CPU one.
W1 replaces no kernel of the JAX package (its source says why it exists).

W1 reads the maps as autograd hands them, without a copy: ``dy`` (N, cout,
h, w) ``channels_last``-contiguous, and ``x`` (N, cin, h, w) channels-last
within each frame at any frame stride (the encoder's first conv reads a
slice of the observation history in place).  It takes cin -> cout of 2 ->
16 and 16 -> 32, the encoder's two convs, at any h, w; its host code
picks the launch from the shape.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import tracing
from ..utils.cuda_build import KERNELS


def conv3x3_wgrad_reference(x, dy):
    """Plain version of W1: ``(dw (cout, cin, 3, 3), db (cout,))`` of
    ``F.conv2d(x, dw, db, padding=1)`` for the output gradient ``dy``, as
    one product of ``dy`` with the unfolded (im2col) input."""
    n, cin, h, w = x.shape
    cout = dy.shape[1]
    cols = F.unfold(x, 3, padding=1)                               # (n, cin * 9, h * w)
    dw = torch.einsum("nol,nkl->ok", dy.reshape(n, cout, h * w), cols)
    return dw.reshape(cout, cin, 3, 3), dy.sum((0, 2, 3))


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library, its entries' signatures set once."""
    lib = KERNELS.get("conv3x3_wgrad")
    lib.conv3x3_wgrad_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    lib.conv3x3_wgrad_plan.restype = ctypes.c_int
    lib.conv3x3_wgrad.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.conv3x3_wgrad.restype = ctypes.c_int
    return lib


def _raise(rc: int, cin: int, cout: int, h: int, w: int):
    """Raise for a return code ``rc`` of the library's entries."""
    if rc == -1:
        raise ValueError(f"conv3x3_wgrad: no launch of {cin} -> {cout} channels on {h} x {w} "
                         "maps (W1 takes 2 -> 16 and 16 -> 32, a map's rows within a block's "
                         "threads and one frame within its shared memory)")
    raise RuntimeError(f"conv3x3_wgrad: kernel launch failed with CUDA error {rc}")


def launch_plan(cin: int, cout: int, h: int, w: int, frames: int, index: int):
    """W1's launch on card ``index`` as its host code picks it from the
    shape: ``(slots, per_slot, blocks)``, a block walking the rows of
    ``slots`` frames at once and ``slots * per_slot`` frames a stage."""
    plan = (ctypes.c_int * 3)()
    rc = _lib().conv3x3_wgrad_plan(cin, cout, h, w, frames, index, plan)
    if rc:
        _raise(rc, cin, cout, h, w)
    return tuple(plan)


def _launch(x, dy):
    """W1 on checked CUDA tensors; raises on a CUDA error.  Counts nothing."""
    n, cin, h, w = x.shape
    cout = dy.shape[1]
    index = x.get_device()
    blocks = launch_plan(cin, cout, h, w, n, index)[2]
    partial = torch.empty((blocks, cout * (cin * 9 + 1)), dtype=torch.float32, device=x.device)
    dw = torch.empty((cout, cin, 3, 3), dtype=torch.float32, device=x.device)
    db = torch.empty((cout,), dtype=torch.float32, device=x.device)
    rc = _lib().conv3x3_wgrad(x.data_ptr(), x.stride(0), dy.data_ptr(), partial.data_ptr(),
                              blocks, dw.data_ptr(), db.data_ptr(), n, cin, cout, h, w, index,
                              torch._C._cuda_getCurrentRawStream(index))
    if rc:
        _raise(rc, cin, cout, h, w)
    return dw, db


def _check(x, dy):
    """Raise unless W1 takes ``x`` and ``dy`` as they are (module docstring)."""
    n, cin, h, w = x.shape if x.dim() == 4 else (0, 0, 0, 0)
    cout = dy.shape[1] if dy.dim() == 4 else 0
    ok = (x.dim() == 4 and dy.shape == (n, cout, h, w) and n > 0
          and x.dtype == dy.dtype == torch.float32 and dy.get_device() == x.get_device()
          and x.stride()[1:] == (1, w * cin, cin) and (n == 1 or x.stride(0) >= h * w * cin)
          and dy.stride() == (h * w * cout, 1, w * cout, cout) and dy.data_ptr() % 16 == 0
          # maps of 4k channels are copied 16 bytes at a time
          and (cin % 4 or (x.data_ptr() % 16 == 0 and x.stride(0) % 4 == 0)))
    if not ok:
        raise ValueError(
            "conv3x3_wgrad: needs float32 x (N, cin, h, w) channels-last within each frame "
            "and dy (N, cout, h, w) channels_last-contiguous, 16-byte aligned (x too where "
            f"cin is a multiple of 4), on one card; got x {x.dtype} {tuple(x.shape)} strides "
            f"{x.stride()} on {x.device}, dy {dy.dtype} {tuple(dy.shape)} strides "
            f"{dy.stride()} on {dy.device}")


def conv3x3_wgrad(x, dy):
    """``(dw, db)``: kernel W1 on a CUDA tensor, its plain version on a CPU
    tensor.  On the card it launches the kernel or raises;
    ``conv3x3_wgrad.launches`` counts the launches.  Under the profiler the
    span ``policy.conv_wgrad`` (counter ``frames``) records the call."""
    with tracing.span("policy.conv_wgrad") as span:
        span.add("frames", x.shape[0])
        if not x.is_cuda:
            if x.device.type == "cpu":
                return conv3x3_wgrad_reference(x, dy)
            raise ValueError(f"conv3x3_wgrad: unsupported device {x.device}")
        _check(x, dy)
        out = _launch(x, dy)
        conv3x3_wgrad.launches += 1
        return out


conv3x3_wgrad.launches = 0


class Conv3x3(torch.autograd.Function):
    """``F.conv2d(x, weight, bias, padding=1)`` for a 3x3 kernel; the
    weight and bias gradients from :func:`conv3x3_wgrad`."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return F.conv2d(x, weight, bias, padding=1)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # the backward-data call autograd makes for F.conv2d
            dx = torch.ops.aten.convolution_backward(
                dy, x, weight, None, (1, 1), (1, 1), (1, 1), False, (0, 0), 1,
                (True, False, False))[0]
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = conv3x3_wgrad(x, dy)
        return dx, dw, db if ctx.needs_input_grad[2] else None


conv3x3 = Conv3x3.apply
