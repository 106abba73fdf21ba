"""Built-in procedural scenes (counterpart of the JAX package's
`scene/procedural.py`).

Each scene is defined once as a *spec*, a dict of numpy arrays (named
material groups, light quad, camera, textures); `_build` turns a spec into
a SceneData on a device, and scene/export.py writes the same spec as
OBJ/MTL + JSON configs.  The specs' arrays equal the JAX package's bit
for bit: a config written from either package's spec loads to the same
scene.
"""
from __future__ import annotations

import math

import numpy as np

from evplp_tpu_torch.scene.camera import Camera
from evplp_tpu_torch.scene.scene import SceneData, build_scene
from evplp_tpu_torch.scene.textures import TexturePoolBuilder


def _quad(p0, p1, p2, p3):
    """Two triangles for quad p0 p1 p2 p3 (ccw)."""
    pos = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
    return pos, idx


def _box(lo, hi):
    """Axis-aligned box as 12 triangles, geometric normals outward."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    quads = [
        ([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),  # bottom -y
        ([x0, y1, z0], [x0, y1, z1], [x1, y1, z1], [x1, y1, z0]),  # top +y
        ([x0, y0, z0], [x0, y1, z0], [x1, y1, z0], [x1, y0, z0]),  # -z
        ([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),  # +z
        ([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]),  # -x
        ([x1, y0, z0], [x1, y1, z0], [x1, y1, z1], [x1, y0, z1]),  # +x
    ]
    pos_list, idx_list = [], []
    off = 0
    for q in quads:
        pos, idx = _quad(*q)
        pos_list.append(pos)
        idx_list.append(idx + off)
        off += 4
    return np.concatenate(pos_list), np.concatenate(idx_list)


def _build(spec, aspect: float = 1.0, device="cuda") -> SceneData:
    """SceneData from a spec dict (groups, light, intensity, camera).

    A group is (name, pos, idx, kd, ks, ns) with an optional 7th dict of
    extras: {"uv": (V, 2) texcoords, "map_kd": texture-name}; texture
    images live in spec["textures"][name] as (H, W, 3) float arrays."""
    cam = spec["camera"]
    camera = Camera(
        origin=tuple(cam["origin"]), look_at=tuple(cam["direction"]),
        up=tuple(cam["up"]), fovy=np.radians(cam["fovy"]), aspect=aspect,
    )
    groups = spec["groups"]
    lpos, lidx = spec["light"]

    pool = TexturePoolBuilder()
    tex_layer = {name: pool.add_image(np.asarray(img, np.float32))
                 for name, img in spec.get("textures", {}).items()}
    uv_list, kd_layers = [], []
    for g in groups:
        extra = g[6] if len(g) > 6 else {}
        uv_list.append(extra.get("uv"))
        kd_layers.append(tex_layer.get(extra.get("map_kd"), -1))
    tex_data, tex_size = pool.build()

    return build_scene(
        positions_list=[g[1] for g in groups],
        indices_list=[g[2] for g in groups],
        kd_list=[np.asarray(g[3], np.float32) for g in groups],
        ks_list=[np.asarray(g[4], np.float32) for g in groups],
        ns_list=[g[5] for g in groups],
        light_positions=lpos, light_indices=lidx,
        light_intensity=np.asarray(spec["intensity"], np.float32),
        camera=camera,
        uv_list=uv_list, kd_layer_list=kd_layers,
        tex_data=tex_data, tex_size=tex_size, device=device,
    )


def cornell_spec(light_intensity=(12.0, 12.0, 12.0, 0.0),
                 glossy_exponent: float = 30.0) -> dict:
    """Cornell-style box in [0,1]^3, camera on +z looking in.

    Walls Lambert (white/red/green); tall block glossy Phong; short block
    Lambert; area light slightly below the ceiling.
    """
    groups = []

    # room: floor, ceiling, back, left(red), right(green) — inward normals
    room_quads = [
        ("floor", ([0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0]), (0.73, 0.73, 0.73)),
        ("ceiling", ([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1]), (0.73, 0.73, 0.73)),
        ("back", ([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]), (0.73, 0.73, 0.73)),
        ("left", ([0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1]), (0.65, 0.05, 0.05)),
        ("right", ([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0]), (0.12, 0.45, 0.15)),
    ]
    for name, quad, kd in room_quads:
        pos, idx = _quad(*quad)
        groups.append((name, pos, idx, kd, (0.0, 0.0, 0.0), 0.0))

    pos, idx = _box([0.10, 0.0, 0.10], [0.40, 0.60, 0.40])
    groups.append(("tallblock", pos, idx, (0.05, 0.05, 0.05),
                   (0.45, 0.45, 0.45), glossy_exponent))
    pos, idx = _box([0.55, 0.0, 0.45], [0.85, 0.30, 0.75])
    groups.append(("shortblock", pos, idx, (0.73, 0.73, 0.73),
                   (0.0, 0.0, 0.0), 0.0))

    ly = 0.995
    light = _quad([0.35, ly, 0.35], [0.65, ly, 0.35],
                  [0.65, ly, 0.65], [0.35, ly, 0.65])  # faces -y (down)
    camera = dict(origin=[0.5, 0.5, 2.6], direction=[0.5, 0.5, 0.0],
                  up=[0.0, 1.0, 0.0], fovy=28.0)
    return dict(groups=groups, light=light,
                intensity=tuple(light_intensity), camera=camera)


def cornell_box(light_intensity=(12.0, 12.0, 12.0, 0.0),
                glossy_exponent: float = 30.0, device="cuda") -> SceneData:
    return _build(cornell_spec(light_intensity, glossy_exponent),
                  device=device)


def glossy_spec(light_intensity=(200.0, 190.0, 160.0, 0.0),
                floor_exponent: float = 80.0) -> dict:
    """EVPLP stress scene: glossy floor + blocker + a SMALL bright light.

    Unclamped VPL fireflies hard here (near-singular G terms under the
    blocker and on the glossy floor); clamped VPL alone loses energy; the
    photon-splat compensation restores it — the paper's core trade
    (rtcomphoton.h misModes 4/5 + photonsplatinstanced.frag residuals).
    """
    groups = []
    room_quads = [
        ("floor", ([0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0]),
         (0.05, 0.05, 0.05), (0.5, 0.5, 0.5), floor_exponent),
        ("ceiling", ([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1]),
         (0.73, 0.73, 0.73), (0, 0, 0), 0.0),
        ("back", ([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]),
         (0.73, 0.73, 0.73), (0, 0, 0), 0.0),
        ("left", ([0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1]),
         (0.65, 0.05, 0.05), (0, 0, 0), 0.0),
        ("right", ([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0]),
         (0.12, 0.45, 0.15), (0, 0, 0), 0.0),
    ]
    for name, quad, kd, ks, ns in room_quads:
        pos, idx = _quad(*quad)
        groups.append((name, pos, idx, kd, ks, ns))

    # low shelf close under the light: creates near-singular VPL geometry
    pos, idx = _box([0.30, 0.0, 0.30], [0.70, 0.08, 0.70])
    groups.append(("shelf", pos, idx, (0.6, 0.6, 0.6), (0.0, 0.0, 0.0), 0.0))

    ly = 0.12  # light close above the shelf
    light = _quad([0.46, ly, 0.46], [0.54, ly, 0.46],
                  [0.54, ly, 0.54], [0.46, ly, 0.54])  # faces -y
    camera = dict(origin=[0.5, 0.55, 2.6], direction=[0.5, 0.35, 0.0],
                  up=[0.0, 1.0, 0.0], fovy=28.0)
    return dict(groups=groups, light=light,
                intensity=tuple(light_intensity), camera=camera)


def glossy_box(light_intensity=(200.0, 190.0, 160.0, 0.0),
               floor_exponent: float = 80.0, device="cuda") -> SceneData:
    return _build(glossy_spec(light_intensity, floor_exponent),
                  device=device)


def _checker_texture(n: int = 256, tiles: int = 8,
                     c0=(0.72, 0.66, 0.55), c1=(0.32, 0.25, 0.18)):
    """Checkerboard (H, W, 3) float image (parquet-style floor)."""
    y, x = np.mgrid[0:n, 0:n]
    cell = ((x * tiles // n) + (y * tiles // n)) % 2
    img = np.where(cell[..., None] > 0, np.asarray(c1, np.float32),
                   np.asarray(c0, np.float32))
    return img.astype(np.float32)


def _wood_texture(n: int = 256, rings: float = 9.0,
                  base=(0.45, 0.29, 0.16), dark=(0.27, 0.16, 0.08)):
    """Concentric-ring wood grain (H, W, 3) float image."""
    y, x = np.mgrid[0:n, 0:n] / n
    r = np.sqrt((x - 0.3) ** 2 + 4.0 * (y - 0.5) ** 2)
    w = 0.5 + 0.5 * np.sin(2 * np.pi * rings * r + 3.0 * x)
    img = (np.asarray(base, np.float32)[None, None]
           + w[..., None] * (np.asarray(dark, np.float32)
                             - np.asarray(base, np.float32)))
    return img.astype(np.float32)


def livingroom_spec(light_intensity=(30.0, 28.0, 24.0, 0.0)) -> dict:
    """Two-room apartment with a doorway and TEXTURED surfaces (map_Kd):
    the third quality-protocol scene (reference: scene/livingroom/).

    Room A (camera + ceiling light): checker parquet floor, sofa, glossy
    wood coffee table, sideboard.  Room B behind a dividing wall with a
    1 m doorway: lit only through the door — multi-room occlusion where
    unclamped VPL fireflies and PT both struggle.
    """
    W, H, D = 5.0, 2.5, 4.0          # x extent, height, z extent
    wall_x = 2.9                     # divider plane (room A: x < wall_x)
    door_z0, door_z1, door_h = 1.4, 2.4, 2.0

    groups = []
    white = (0.68, 0.68, 0.66)

    def add(name, pos, idx, kd, ks=(0, 0, 0), ns=0.0, extra=None):
        groups.append((name, pos, idx, kd, ks, ns)
                      + ((extra,) if extra else ()))

    # floor with checker texture, uv ~1.6 tiles/m (REPEAT wrap)
    fpos, fidx = _quad([0, 0, 0], [0, 0, D], [W, 0, D], [W, 0, 0])
    fuv = np.asarray([[0, 0], [0, D * 1.6], [W * 1.6, D * 1.6],
                      [W * 1.6, 0]], np.float32)
    add("floor", fpos, fidx, (1.0, 1.0, 1.0), (0.06, 0.06, 0.06), 6.0,
        {"uv": fuv, "map_kd": "parquet"})

    cpos, cidx = _quad([0, H, 0], [W, H, 0], [W, H, D], [0, H, D])
    add("ceiling", cpos, cidx, white)
    for name, quad, kd in [
        ("back", ([0, 0, 0], [W, 0, 0], [W, H, 0], [0, H, 0]), white),
        ("front", ([0, 0, D], [0, H, D], [W, H, D], [W, 0, D]), white),
        ("left", ([0, 0, 0], [0, H, 0], [0, H, D], [0, 0, D]),
         (0.55, 0.28, 0.20)),                       # terracotta accent
        ("right", ([W, 0, 0], [W, 0, D], [W, H, D], [W, H, 0]),
         (0.35, 0.45, 0.55)),                       # slate accent
    ]:
        pos, idx = _quad(*quad)
        add(name, pos, idx, kd)

    # dividing wall: three slabs around the doorway (thin box, two faces)
    for i, (z0, z1, y0, y1) in enumerate([
            (0.0, door_z0, 0.0, H),          # below-door-z segment
            (door_z1, D, 0.0, H),            # above-door-z segment
            (door_z0, door_z1, door_h, H)]):  # lintel over the door
        pos, idx = _box([wall_x - 0.05, y0, z0], [wall_x + 0.05, y1, z1])
        add(f"divider{i}", pos, idx, white)

    # --- room A furnishings ---
    for i, (lo, hi) in enumerate([
            ([0.25, 0.0, 2.6], [1.45, 0.45, 3.35]),   # sofa seat
            ([0.25, 0.45, 3.20], [1.45, 1.00, 3.50]),  # sofa back
            ([0.25, 0.45, 2.60], [0.45, 0.75, 3.20]),  # armrest
            ([1.25, 0.45, 2.60], [1.45, 0.75, 3.20])]):
        pos, idx = _box(lo, hi)
        add(f"sofa{i}", pos, idx, (0.30, 0.34, 0.50))
    # coffee table: glossy wood top + legs
    tpos, tidx = _box([1.65, 0.42, 2.45], [2.45, 0.50, 3.15])
    nuv = np.zeros((tpos.shape[0], 2), np.float32)
    nuv[:, 0] = (tpos[:, 0] - 1.65) / 0.8
    nuv[:, 1] = (tpos[:, 2] - 2.45) / 0.7
    add("tabletop", tpos, tidx, (1.0, 1.0, 1.0), (0.25, 0.25, 0.25), 25.0,
        {"uv": nuv, "map_kd": "wood"})
    for i, (lx, lz) in enumerate([(1.70, 2.50), (2.35, 2.50),
                                  (1.70, 3.05), (2.35, 3.05)]):
        pos, idx = _box([lx, 0.0, lz], [lx + 0.06, 0.42, lz + 0.06])
        add(f"leg{i}", pos, idx, (0.20, 0.12, 0.07))
    # sideboard along the back wall
    pos, idx = _box([0.3, 0.0, 0.1], [1.8, 0.8, 0.55])
    add("sideboard", pos, idx, (0.50, 0.36, 0.24), (0.1, 0.1, 0.1), 12.0)

    # --- room B (through the door): bed + shelf, indirect-lit ---
    pos, idx = _box([3.4, 0.0, 0.4], [4.8, 0.5, 2.4])
    add("bed", pos, idx, (0.58, 0.55, 0.48))
    pos, idx = _box([3.1, 0.0, 3.3], [4.9, 1.5, 3.8])
    add("wardrobe", pos, idx, (0.42, 0.30, 0.20))

    # ceiling light in room A
    ly = H - 0.01
    light = _quad([1.0, ly, 1.2], [1.9, ly, 1.2],
                  [1.9, ly, 2.1], [1.0, ly, 2.1])   # faces -y
    camera = dict(origin=[0.55, 1.5, 3.7], direction=[3.4, 0.8, 1.3],
                  up=[0.0, 1.0, 0.0], fovy=55.0)
    return dict(groups=groups, light=light,
                intensity=tuple(light_intensity), camera=camera,
                textures={"parquet": _checker_texture(),
                          "wood": _wood_texture()})


def livingroom(light_intensity=(30.0, 28.0, 24.0, 0.0),
               device="cuda") -> SceneData:
    return _build(livingroom_spec(light_intensity), device=device)


def box_field_spec(num_boxes: int = 2000, seed: int = 0,
                   light_intensity=(40.0, 38.0, 30.0, 0.0),
                   room_scale: float = 1.0) -> dict:
    """Large scene for BVH-path benchmarking: a field of random boxes
    (~12*num_boxes triangles) in a Cornell-style room with a ceiling light.

    room_scale stretches the room floor plan (x/z) so triangle count can
    grow at CONSTANT box density: with room_scale = sqrt(n/8500) an
    n-box field has the same boxes-per-area as the 102k-triangle
    headline scene (a fixed room at high counts degenerates into box
    fog, which measures scene hardness rather than tracer scaling)."""
    rng = np.random.default_rng(seed)
    groups = []
    w = 4.0 * room_scale

    room_quads = [
        ("floor", ([0, 0, 0], [0, 0, w], [w, 0, w], [w, 0, 0])),
        ("ceiling", ([0, 2, 0], [w, 2, 0], [w, 2, w], [0, 2, w])),
        ("back", ([0, 0, 0], [w, 0, 0], [w, 2, 0], [0, 2, 0])),
        ("left", ([0, 0, 0], [0, 2, 0], [0, 2, w], [0, 0, w])),
        ("right", ([w, 0, 0], [w, 0, w], [w, 2, w], [w, 2, 0])),
    ]
    for name, quad in room_quads:
        pos, idx = _quad(*quad)
        groups.append((name, pos, idx, (0.7, 0.7, 0.7), (0.0, 0.0, 0.0), 0.0))

    centers = rng.uniform([0.2, 0.0, 0.2], [w - 0.2, 1.0, w - 0.2],
                          (num_boxes, 3))
    sizes = rng.uniform(0.02, 0.08, (num_boxes, 3))
    pos_list, idx_list = [], []
    off = 0
    for c, s in zip(centers, sizes):
        pos, idx = _box(c - s, c + s)
        pos_list.append(pos)
        idx_list.append(idx + off)
        off += pos.shape[0]
    groups.append(("boxes", np.concatenate(pos_list),
                   np.concatenate(idx_list),
                   (0.4, 0.45, 0.6), (0.2, 0.2, 0.2), 15.0))

    ly = 1.99
    cx = w / 2.0
    light = _quad([cx - 0.4, ly, cx - 0.4], [cx + 0.4, ly, cx - 0.4],
                  [cx + 0.4, ly, cx + 0.4], [cx - 0.4, ly, cx + 0.4])
    camera = dict(origin=[cx, 1.2, w + 3.0], direction=[cx, 0.8, 0.0],
                  up=[0.0, 1.0, 0.0], fovy=35.0)
    return dict(groups=groups, light=light,
                intensity=tuple(light_intensity), camera=camera)


def box_field(num_boxes: int = 2000, seed: int = 0,
              light_intensity=(40.0, 38.0, 30.0, 0.0),
              room_scale: float = 1.0, device="cuda") -> SceneData:
    return _build(box_field_spec(num_boxes, seed, light_intensity,
                                 room_scale), device=device)


def box_field_big_spec(num_boxes: int = 25_000) -> dict:
    """~300k-triangle quality scene: crosses the `big` layout threshold
    (scene.py: >280k tris -> 42-tri leaves + fused node rows), so its
    RMSE rows execute the fused-meta production path end-to-end —
    the tier the 33k-tri box_field cannot reach.  Constant box density
    via room_scale (see box_field_spec)."""
    return box_field_spec(num_boxes, seed=0,
                          room_scale=math.sqrt(num_boxes / 8500.0))


def box_field_big(num_boxes: int = 25_000, device="cuda") -> SceneData:
    return _build(box_field_big_spec(num_boxes), device=device)


def furnace_scene(intensity: float = 2.0, albedo: float = 0.65,
                  device="cuda") -> SceneData:
    """Analytic "furnace" enclosure: the ENTIRE [0,1]^3 cube interior is the
    area light (uniform emitted radiance), with a small Lambertian patch at
    the center and the camera just above it looking down.

    Closed form: with config intensity I and phong exponent 0, the emitted
    radiance is direction-independent L_e = I (pi-premultiply at load,
    rtcommon.h:782, cancels the (0+2)/(2pi) profile, rtmaterial.cuh:112-118).
    The patch sees L_e over its whole upper hemisphere, so its irradiance is
    pi*I and its reflected radiance is

        L = albedo * I          (any viewing direction)

    exactly — for PT, for the VPL estimator (vertex-0 records reproduce the
    emission profile), and for clamped-VPL + photon compensation (EVPLP).
    The light walls are black (build_scene gives the emitter mesh black
    material), so transport stops after one bounce and the closed form has
    no multi-bounce correction.
    """
    cpos, cidx = _box([0.0, 0.0, 0.0], [1.0, 1.0, 1.0])
    cidx = cidx[:, ::-1]                      # inward-facing normals
    # patch faces +y (same winding as cornell's floor)
    ppos, pidx = _quad([0.35, 0.5, 0.35], [0.35, 0.5, 0.65],
                       [0.65, 0.5, 0.65], [0.65, 0.5, 0.35])
    camera = Camera(
        origin=(0.5, 0.62, 0.5), look_at=(0.5, 0.0, 0.5), up=(0.0, 0.0, 1.0),
        fovy=np.radians(50.0), aspect=1.0,
    )
    return build_scene(
        positions_list=[ppos], indices_list=[pidx],
        kd_list=[np.full(3, albedo, np.float32)],
        ks_list=[np.zeros(3, np.float32)], ns_list=[0.0],
        light_positions=cpos, light_indices=cidx,
        light_intensity=np.asarray([intensity, intensity, intensity, 0.0],
                                   np.float32),
        camera=camera, device=device,
    )


def plane_light_scene(light_intensity=(5.0, 5.0, 5.0, 0.0),
                      device="cuda") -> SceneData:
    """Minimal scene: one diffuse floor + one overhead light quad.

    Has a closed-form direct-lighting answer at the floor center for
    analytic tests.
    """
    fpos, fidx = _quad([-5, 0, -5], [-5, 0, 5], [5, 0, 5], [5, 0, -5])  # +y
    lpos, lidx = _quad([-0.5, 2.0, -0.5], [0.5, 2.0, -0.5],
                       [0.5, 2.0, 0.5], [-0.5, 2.0, 0.5])  # faces -y
    camera = Camera(
        origin=(0.0, 1.0, 4.0), look_at=(0.0, 0.5, 0.0), up=(0.0, 1.0, 0.0),
        fovy=np.radians(45.0), aspect=1.0,
    )
    return build_scene(
        positions_list=[fpos], indices_list=[fidx],
        kd_list=[np.asarray([0.5, 0.5, 0.5], np.float32)],
        ks_list=[np.zeros(3, np.float32)], ns_list=[0.0],
        light_positions=lpos, light_indices=lidx,
        light_intensity=np.asarray(light_intensity, np.float32),
        camera=camera, device=device,
    )
