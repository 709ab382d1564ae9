"""The physics of an env step as one CUDA graph replay.

:class:`PhysicsStep` is what both envs run under their ``env.physics``
span: the contact window around each env's base
(``terrain.heightfield.contact_window``) and the decimated
``engine.control_step`` with the env's torque function.  Eagerly that is
about 3,400 small kernels a step, each launched from Python.  On CUDA
tensors the object captures the block once into a ``torch.cuda.CUDAGraph``
and replays it on every later call, one launch for all of them:

- **in**: the step's inputs (the physics state, the ``PhysParams``, the
  actuator carry) are copied into static buffers the graph reads;
- **out**: every output the graph wrote is copied out into a fresh tensor,
  so no caller ever holds the graph's memory, which the next replay
  overwrites.  An output that is an input passed through (a carry entry
  the torque function does not change) is the caller's own tensor, as in
  the eager code.

The graph is keyed on what the call can observe: each input's shape, dtype
and device, the terrain's static arrays by address and its Python
constants.  A call whose key differs (a new env count, a terrain replaced
by ``set_shard``) captures anew; a stale address is never replayed.  The
model, the torque function and the step's constants are the object's own,
fixed when it is built.  The physics draws no random numbers and, with
the model's device twins (``model.py``), makes no host sync, which is what
capture needs.  The kernels, and so the numbers, are the eager ones.

On CPU tensors the call runs the eager code.  A call is the tracer's
``env.physics`` span, whose ``graph`` counter is 1 for a call that only
replayed and 0 for any other (an eager call, or the call that captured),
and whose ``captures`` counter is 1 on the call that captured.  The capture
runs on the inputs' card, on a stream of that card, and in
``thread_local`` mode, so that what other threads of the process do
meanwhile (NCCL's watchdog, say) does not break it.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .. import tracing
from ..terrain.heightfield import TerrainArrays, contact_window
from .contact import ContactWindow
from .engine import PhysParams, PhysState, control_step
from .model import Go1Model


class PhysicsStep:
    """The contact window and decimated control step of every env (the
    module docstring), as one graph replay on the card."""

    def __init__(self, model: Go1Model, torque_fn: Callable, patch_x: int, patch_y: int,
                 sim_dt: float, decimation: int, contact_stiffness: float,
                 contact_damping: float, joint_limit_stiffness: float,
                 joint_limit_damping: float):
        self.model, self.torque_fn = model, torque_fn
        self.patch = (patch_x, patch_y)
        self.constants = (sim_dt, decimation, contact_stiffness, contact_damping,
                          joint_limit_stiffness, joint_limit_damping)
        self.captures = 0
        self._key = self._graph = self._static_in = self._static_out = self._out_spec = None
        self._out_src = None

    def eager(self, terrain: TerrainArrays, tile_table: torch.Tensor, phys: PhysState,
              params: PhysParams, carry):
        """The block as the envs ran it before the graph: ``(PhysState,
        carry, StepAux)``."""
        xs, ys, PX, PY = contact_window(terrain, phys.base_pos[:, :2], *self.patch)
        window = ContactWindow(tile_table, terrain.env_tile, xs, ys, PX, PY)
        return control_step(self.model, terrain, window, terrain.env_terrain_origin, phys,
                            self.torque_fn, carry, params, *self.constants)

    def __call__(self, terrain: TerrainArrays, tile_table: torch.Tensor, phys: PhysState,
                 params: PhysParams, carry):
        """``(PhysState, carry, StepAux)`` of :meth:`eager`, by a graph
        replay on CUDA tensors."""
        with tracing.span("env.physics") as span:
            inputs = (phys, params, carry)
            flat, _ = tree_flatten(inputs)
            if flat[0].device.type != "cuda":
                span.add("graph", 0)
                return self.eager(terrain, tile_table, *inputs)
            key = self._key_of(terrain, tile_table, flat)
            with torch.cuda.device(flat[0].device):
                captured = key != self._key
                if captured:
                    self._capture(terrain, tile_table, inputs, key)
                    span.add("captures", 1)
                for s, x in zip(self._static_in, flat):
                    s.copy_(x)
                self._graph.replay()
            span.add("graph", 0 if captured else 1)
            out = [t.clone() if i is None else flat[i]
                   for t, i in zip(self._static_out, self._out_src)]
            return tree_unflatten(out, self._out_spec)

    def _key_of(self, terrain: TerrainArrays, tile_table: torch.Tensor, flat: list) -> tuple:
        device = flat[0].device
        arrays = (terrain.env_tile, terrain.env_terrain_origin, tile_table)
        for t in flat + list(arrays):
            if t.device != device:
                raise ValueError(f"the physics step's tensors span {device} and {t.device}")
        return (tuple((t.shape, t.dtype) for t in flat),
                tuple((t.data_ptr(), t.shape, t.dtype, t.stride()) for t in arrays),
                tuple(terrain.tiles.shape), terrain.horizontal_scale, terrain.is_plane,
                terrain.ceiling_top, device)

    def _capture(self, terrain: TerrainArrays, tile_table: torch.Tensor, inputs, key):
        """Run the block once eagerly (cuBLAS's handle, the kernels' first
        loads), then capture it into a new graph that reads static copies
        of ``inputs``."""
        self._key = self._graph = self._static_in = self._static_out = self._out_spec = None
        flat, spec = tree_flatten(inputs)
        static_in = [t.clone(memory_format=torch.contiguous_format) for t in flat]
        static_inputs = tree_unflatten(static_in, spec)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad():
            self.eager(terrain, tile_table, *static_inputs)
            # cuBLAS keeps a workspace for each stream it ran on, for good.
            # Cleared before the capture, the capture stream's is allocated
            # in the graph's own pool, and cleared after it, nothing but the
            # graph holds it: no workspace outlives the graph.
            torch._C._cuda_clearCublasWorkspaces()
            # a capture stream of the inputs' card: torch.cuda.graph's own
            # is made once a process, on the card current at its first use
            stream = torch.cuda.Stream(flat[0].device)
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                out = self.eager(terrain, tile_table, *static_inputs)
            torch._C._cuda_clearCublasWorkspaces()
        # an output that is a static input passed through (a carry entry the
        # torque function keeps) is given back as the caller's own input
        index = {id(s): i for i, s in enumerate(static_in)}
        self._graph, self._static_in = graph, static_in
        self._static_out, self._out_spec = tree_flatten(out)
        self._out_src = [index.get(id(t)) for t in self._static_out]
        self._key = key
        self.captures += 1
