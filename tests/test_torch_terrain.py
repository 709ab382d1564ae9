"""Parity of the port's terrain pieces with the JAX package on the CPU.

- the tunnel builder, bitwise;
- the contact sampler (direct gather) against ``sample_patch_bilinear`` on
  the granule window, bitwise;
- the flat bilinear sampler (``sample_height_bilinear``, the contact
  sampler's oracle) against the jitted JAX one, bitwise, and the contact
  sampler against it at the JAX package's bars;
- kernel B1's plain version against the Pallas kernel in interpret mode and
  against the XLA patch path, bitwise, off-tile clamps included;
- kernel B1's launch shape (envs per block, blocks, shared memory).

Kernel B1 itself is held to its plain version on the card by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_support  # noqa: F401
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from legged_tracking_torch.config import Cfg as TCfg
from legged_tracking_torch.config import config_go1 as t_config_go1
from legged_tracking_torch.terrain import heightfield as t_hf
from legged_tracking_torch.terrain import scan as t_scan
from legged_tracking_torch.terrain.tunnel import build_terrain as t_build_terrain
from legged_tracking_tpu.config import Cfg, config_go1
from legged_tracking_tpu.terrain import heightfield as j_hf
from legged_tracking_tpu.terrain.pallas_scan import scan_heights_pallas
from legged_tracking_tpu.terrain.tunnel import build_terrain


def _cfg(cfg_cls, go1, terrain_type, rows=2, cols=2):
    cfg = go1(cfg_cls())
    cfg.terrain.mesh_type = "trimesh"
    cfg.terrain.terrain_type = terrain_type
    cfg.terrain.num_rows = rows
    cfg.terrain.num_cols = cols
    cfg.terrain.terrain_length = 4.0
    cfg.terrain.terrain_width = 2.0
    cfg.terrain.terrain_ratio_x = 0.9
    cfg.terrain.terrain_ratio_y = 0.5
    cfg.terrain.ceiling_height = 0.8
    cfg.terrain.start_loc = 0.32
    return cfg


N = 8


@pytest.fixture(scope="module")
def terrains():
    """The same single_path world built by both packages (8 envs, 2x2 tiles)."""
    jt = build_terrain(_cfg(Cfg, config_go1, "single_path"), N, seed=3)
    tt = t_build_terrain(_cfg(TCfg, t_config_go1, "single_path"), N, seed=3, device="cpu")
    return jt, tt


@pytest.mark.parametrize("terrain_type", ["single_path", "narrow_path", "random_pyramid",
                                          "random"])
def test_tunnel_builder_bitwise(terrain_type):
    jt = build_terrain(_cfg(Cfg, config_go1, terrain_type), N, seed=5)
    tt = t_build_terrain(_cfg(TCfg, t_config_go1, terrain_type), N, seed=5, device="cpu")
    for name in ("tiles", "env_tile", "env_origin", "env_terrain_origin"):
        a, b = np.asarray(getattr(jt, name)), getattr(tt, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert (tt.horizontal_scale, tt.is_plane, tt.ceiling_top) == \
        (jt.horizontal_scale, jt.is_plane, jt.ceiling_top)


def test_bf16_table_rounds_like_jax(terrains):
    jt, tt = terrains
    # tiles + an odd-ulp offset, so that round-to-nearest-even matters
    vals = np.asarray(jt.tiles) + np.float32(2.0 ** -10)
    a = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16).astype(jnp.float32))
    b = torch.as_tensor(vals).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("px,py", [(24, 16), (32, 32)])
def test_contact_sampler_matches_patch_bilinear(terrains, px, py):
    """The direct gather reproduces sample_patch_bilinear on the granule
    window bit for bit (atol 0): same clamps, same bf16 roundings, and each
    f32 sum adds at most two exact products of bf16 values."""
    jt, tt = terrains
    rng = np.random.RandomState(11)
    base = np.asarray(jt.env_origin)[:, :2] + rng.uniform(-0.3, 0.3, (N, 2))
    base = base.astype(np.float32)
    # in-window points, points past the window edge (window clamp) and
    # points off the tile (tile clamp)
    pts = np.concatenate([base[:, None] + rng.uniform(-0.5, 0.5, (N, 40, 2)),
                          base[:, None] + rng.uniform(-1.5, 1.5, (N, 16, 2)),
                          base[:, None] + rng.uniform(-9.0, 9.0, (N, 8, 2))],
                         axis=1).astype(np.float32)
    th, tw = jt.tiles.shape[2], jt.tiles.shape[3]

    @jax.jit       # as the JAX env runs it: "/ hs" compiles to "* (1 / hs)"
    def ref(base, pts):
        patch, xs, ys = j_hf.extract_patches_batched_granule(
            jt, jt.env_tile, jt.env_terrain_origin, base, px, py)
        return xs, ys, patch, jax.vmap(
            j_hf.sample_patch_bilinear, in_axes=(0, 0, 0, None, None, None, 0, 0))(
            patch, xs, ys, jt.horizontal_scale, th, tw, jt.env_terrain_origin, pts)

    xs, ys, patch, (ref_h, ref_g) = ref(jnp.asarray(base), jnp.asarray(pts))

    txs, tys, PX, PY = t_hf.contact_window(tt, torch.as_tensor(base), px, py)
    np.testing.assert_array_equal(txs.numpy(), np.asarray(xs))
    np.testing.assert_array_equal(tys.numpy(), np.asarray(ys))
    assert (PX, PY) == tuple(patch.shape[2:])
    h, g = t_hf.sample_window_bilinear(t_hf.bf16_table(tt), tt.env_tile, txs, tys, PX, PY,
                                       tt.horizontal_scale, tt.env_terrain_origin,
                                       torch.as_tensor(pts))
    np.testing.assert_array_equal(h.numpy(), np.asarray(ref_h))
    np.testing.assert_array_equal(g.numpy(), np.asarray(ref_g))


@pytest.fixture(scope="module")
def jax_flat(terrains):
    """``sample_height_bilinear`` jitted with the terrain closed over, so
    that ``hs`` is a constant, as on every JAX path; and on the tiles
    quantized to bf16."""
    jt, _ = terrains
    jq = jt._replace(tiles=jt.tiles.astype(jnp.bfloat16).astype(jnp.float32))
    return {name: jax.jit(lambda p, t=t: j_hf.sample_height_bilinear(
        t, t.env_tile, t.env_terrain_origin, p)) for name, t in (("f32", jt), ("bf16", jq))}


def _flat_points(jt, case):
    """(N, 48, 2) float32 points: within 0.5 m and 1.5 m of the spawn bases;
    on cell boundaries (whole cells from the tile origin); or up to 9 m off,
    most past the tile, where the clip to h - 1.001 and w - 1.001 holds
    them on the last cell."""
    rng = np.random.RandomState({"random": 0, "grid_aligned": 1, "off_tile": 2}[case])
    base = np.asarray(jt.env_origin)[:, None, :2]
    if case == "random":
        pts = np.concatenate([base + rng.uniform(-0.5, 0.5, (N, 32, 2)),
                              base + rng.uniform(-1.5, 1.5, (N, 16, 2))], axis=1)
    elif case == "grid_aligned":
        cells = rng.randint(0, [jt.tiles.shape[2] - 1, jt.tiles.shape[3] - 1], (N, 48, 2))
        pts = (np.asarray(jt.env_terrain_origin)[:, None, :2]
               + cells.astype(np.float32) * np.float32(jt.horizontal_scale))
    else:
        pts = base + rng.uniform(-9.0, 9.0, (N, 48, 2))
    return pts.astype(np.float32)


@pytest.mark.parametrize("tiles", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["random", "grid_aligned", "off_tile"])
def test_flat_sampler_matches_jitted_jax(terrains, jax_flat, case, tiles, monkeypatch):
    """The flat bilinear sampler against the jitted JAX one, bitwise (atol
    0): at points near the bases, on cell boundaries and off the tile; on
    the float32 tiles and on the bf16 table (read as float32) against JAX
    on the tiles quantized to bf16.  On cell boundaries the source's true
    ``/ hs`` picks other cells and misses."""
    jt, tt = terrains
    pts = _flat_points(jt, case)
    ref_h, ref_g = (np.asarray(a) for a in jax_flat[tiles](jnp.asarray(pts)))
    t = tt._replace(tiles=t_hf.bf16_table(tt)) if tiles == "bf16" else tt
    sample = lambda: t_hf.sample_height_bilinear(t, t.env_tile, t.env_terrain_origin,
                                                 torch.as_tensor(pts))
    h, g = sample()
    assert h.dtype == g.dtype == torch.float32
    assert h.shape == (N, 48, 2) and g.shape == (N, 48, 2, 2)
    np.testing.assert_array_equal(h.numpy(), ref_h)
    np.testing.assert_array_equal(g.numpy(), ref_g)
    if case == "off_tile":
        hs, (th, tw) = jt.horizontal_scale, jt.tiles.shape[2:]
        local = (pts - np.asarray(jt.env_terrain_origin)[:, None, :2]) / hs
        assert (local[..., 0] > th - 1).mean() > 0.2 and (local[..., 1] > tw - 1).mean() > 0.2
    if case == "grid_aligned":
        monkeypatch.setattr(t_hf, "to_cells", lambda x, hs: x / hs)
        h_div, g_div = sample()
        assert not (np.array_equal(h_div.numpy(), ref_h) and np.array_equal(g_div.numpy(), ref_g))


def test_window_sampler_matches_flat(terrains):
    """The contact sampler (window of 32 x 32 cells, bf16 stages) against the
    flat float32 sampler on the bf16-quantized tiles, at 16 points an env
    within 0.5 m of its origin: within the JAX package's bars of
    tests/test_heightfield.py, atol 6e-3 on heights (reading 1.6e-3) and
    5e-2 on gradients (reading 2.0e-2); chip_smoke.py's check at 4096 envs."""
    _, tt = terrains
    errs = chip_smoke.flat_vs_window(tt)
    assert errs["height"] <= chip_smoke.FLAT_BARS["height"], errs
    assert errs["grad"] <= chip_smoke.FLAT_BARS["grad"], errs
    assert errs["height"] > 0.0 and errs["grad"] > 0.0     # the bf16 stages show


def test_window_vs_flat_at_bench_tiles_matches_jax():
    """On the bench's 32 x 32 tiles at 1024 envs x 16 points (chip_smoke.py's
    draw), the JAX package's own check of tests/test_heightfield.py (its
    patch path against its flat sampler) and the port's give the same max
    errors, 4.88e-3 on heights and 6.91e-2 on gradients: the JAX 5e-2 bar,
    read at 128 points, does not hold at this width for either package.
    Both stay within the worst case of the bf16 stages."""
    n = 1024
    tt = chip_smoke.bench_terrain(n, "cpu")
    jcfg = _cfg(Cfg, config_go1, "single_path", rows=32, cols=32)
    jt = build_terrain(jcfg, n, seed=jcfg.seed)
    np.testing.assert_array_equal(np.asarray(jt.tiles), tt.tiles.numpy())
    errs = chip_smoke.flat_vs_window(tt)
    pts = jnp.asarray(errs["run"][1].numpy())
    jq = jt._replace(tiles=jt.tiles.astype(jnp.bfloat16).astype(jnp.float32))
    th, tw = jt.tiles.shape[2], jt.tiles.shape[3]

    @jax.jit
    def jax_errs(pts):
        h_flat, g_flat = j_hf.sample_height_bilinear(jq, jt.env_tile, jt.env_terrain_origin, pts)
        pb, xs, ys = j_hf.extract_patches_batched(jt, jt.env_tile, jt.env_terrain_origin,
                                                  jt.env_origin[:, :2])
        h_patch, g_patch = jax.vmap(
            j_hf.sample_patch_bilinear, in_axes=(0, 0, 0, None, None, None, 0, 0))(
            pb, xs, ys, jt.horizontal_scale, th, tw, jt.env_terrain_origin, pts)
        return jnp.abs(h_patch - h_flat).max(), jnp.abs(g_patch - g_flat).max()

    want = [float(e) for e in jax_errs(pts)]
    assert [errs["height"], errs["grad"]] == want
    assert want[1] > chip_smoke.FLAT_BARS["grad"]
    bound = chip_smoke.bf16_stage_bounds(errs["run"][0].tiles, tt.horizontal_scale)
    assert errs["height"] <= bound["height"] and errs["grad"] <= bound["grad"]


def _grid():
    gx, gy = np.meshgrid(np.linspace(-1, 1, 21), np.linspace(-0.5, 0.5, 11), indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)


def _frames(base, cam_x, origin):
    cam = np.stack([cam_x, np.zeros_like(cam_x)], -1)
    return np.stack([base, cam, origin[:, :2]], axis=1).astype(np.float32)


@pytest.mark.parametrize("case", ["on_tile", "grid_aligned", "off_tile"])
def test_scan_plain_matches_pallas_and_xla(terrains, case):
    """B1's plain version == scan_heights_pallas (interpret mode) == the XLA
    patch path of the JAX env, bitwise (atol 0): at random bases with a
    camera shift; at the spawn bases, where every scan point lies on a cell
    boundary and only "* (1 / hs)", as XLA compiles the JAX "/ hs", picks
    the JAX cell (a true division flips cells by up to 0.1 m); and at bases
    10 m past the tiles, where every point clamps to the edge cell."""
    jt, tt = terrains
    rng = np.random.RandomState(7)
    base = np.asarray(jt.env_origin)[:, :2]
    cam_x = np.full(N, 0.12, np.float32)
    if case != "grid_aligned":
        base = base + rng.uniform(-0.2, 0.2, (N, 2)) + (10.0 if case == "off_tile" else 0.0)
        cam_x = (0.12 * np.cos(rng.uniform(-0.3, 0.3, N))).astype(np.float32)
    frames = _frames(base.astype(np.float32), cam_x, np.asarray(jt.env_terrain_origin))
    grid = _grid()

    ref = np.asarray(scan_heights_pallas(jt.tiles, jt.env_tile, jnp.asarray(frames),
                                         jnp.asarray(grid), jt.horizontal_scale,
                                         interpret=True))
    out = t_scan.scan_heights(t_hf.bf16_table(tt), tt.env_tile, torch.as_tensor(frames),
                              torch.as_tensor(grid), tt.horizontal_scale)
    np.testing.assert_array_equal(out.numpy(), ref)

    # the XLA patch path of the JAX env (_get_heights with fused sampling)
    th, tw = jt.tiles.shape[2], jt.tiles.shape[3]

    @jax.jit
    def xla(frames, grid):
        pts = (grid[None] + frames[:, None, 0]) + frames[:, None, 1]
        pb, xs, ys = j_hf.extract_patches_batched(jt, jt.env_tile, jt.env_terrain_origin,
                                                  frames[:, 0], 64, 40)
        return jax.vmap(j_hf.sample_patch_nearest_fused,
                        in_axes=(0, 0, 0, None, None, None, 0, 0))(
            j_hf.transpose_patch(pb), xs, ys, jt.horizontal_scale, th, tw,
            jt.env_terrain_origin, pts)

    h = np.asarray(xla(jnp.asarray(frames), jnp.asarray(grid)))
    np.testing.assert_array_equal(out.numpy(), np.moveaxis(h, -1, 1))
    if case == "off_tile":
        edge = torch.as_tensor(np.array(jt.tiles)).to(torch.bfloat16).float()[
            tt.env_tile.long()][:, :, -2, -2]
        np.testing.assert_array_equal(out.numpy(), edge[:, :, None].expand_as(out).numpy())


def test_scan_wrapper_on_cpu_runs_plain_version(terrains):
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing; the launch count moves only on the card."""
    _, tt = terrains
    before = t_scan.scan_heights.launches
    frames = torch.zeros(N, 3, 2)
    t_scan.scan_heights(t_hf.bf16_table(tt), tt.env_tile, frames, torch.as_tensor(_grid()),
                        tt.horizontal_scale)
    assert t_scan.scan_heights.launches == before


@settings(max_examples=300, deadline=None, database=None)
@given(N=st.integers(1, 2_000_000), P=st.integers(1, 9_682), sm=st.integers(1, 200))
def test_scan_launch_shape_properties(N, P, sm):
    """Kernel B1's launch shape: E even, so that each block's output span is
    a multiple of 16 bytes at a 16-byte-aligned offset (the bulk store),
    and at most one env per thread; the staging fits a block; the blocks
    cover the N envs exactly once; one wave whenever shared memory and the
    cap on E allow it; no smaller E gives one wave."""
    E, blocks, smem = t_scan.launch_shape(N, P, sm)
    assert 2 <= E <= t_scan.THREADS and E % 2 == 0
    assert (8 * E * P) % 16 == 0 and (8 * E * P * (blocks - 1)) % 16 == 0
    assert smem == t_scan.staging_bytes(E, P) <= t_scan.SMEM_BLOCK
    assert (blocks - 1) * E < N <= blocks * E
    wave = sm * t_scan.RESIDENT
    fits = lambda e: t_scan.RESIDENT * (t_scan.staging_bytes(e, P) + t_scan.SMEM_RESERVED) \
        <= t_scan.SMEM_SM
    assert E == 2 or fits(E)
    assert blocks <= wave or E == t_scan.THREADS or not fits(E + 2)
    assert E == 2 or -(-N // (E - 2)) > wave


@pytest.mark.parametrize("N,P,sm,shape", [
    (4096, 231, 132, (8, 512, 16_888)),     # the bench: one wave of 512 blocks
    (4099, 1353, 132, (4, 1025, 54_248)),   # a 33x41 grid: past 48 KB, E cut to 4
    (1, 1, 132, (2, 1, 88)),                # one env: a tail block
])
def test_scan_launch_shape_cases(N, P, sm, shape):
    assert t_scan.launch_shape(N, P, sm) == shape


def test_scan_launch_shape_refuses_grids_past_shared_memory():
    assert t_scan.staging_bytes(2, 9_682) <= t_scan.SMEM_BLOCK < t_scan.staging_bytes(2, 9_683)
    t_scan.launch_shape(8, 9_682, 132)
    with pytest.raises(ValueError):
        t_scan.launch_shape(8, 9_683, 132)


def test_scan_wrapper_refuses_other_devices():
    """Neither a CPU nor a CUDA tensor: the wrapper raises, it does not
    fall back to the plain version."""
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        t_scan.scan_heights(torch.zeros(2, 2, 4, 4, dtype=torch.bfloat16, **meta),
                            torch.zeros(3, dtype=torch.int32, **meta),
                            torch.zeros(3, 3, 2, **meta), torch.zeros(5, 2, **meta), 0.05)
