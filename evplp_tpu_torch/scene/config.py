"""Reference-format JSON config loading (counterpart of the JAX package's
`scene/config.py`).

The schema is the reference's: resX/resY, scene:[obj...], arealight:{obj,
intensity}, camera|stablecamera:{origin, direction, up, fovy|fovx}, and one
technique block among "pt" / "photonfam" / "lvcphotonfam".  OBJ paths are
relative to the JSON file; unknown keys are ignored; the removed
"clampingStart" key errors.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from evplp_tpu_torch.scene.camera import Camera
from evplp_tpu_torch.scene.objloader import load_obj
from evplp_tpu_torch.scene.scene import SceneData, build_scene

TECHNIQUE_KEYS = ("pt", "photonfam", "lvcphotonfam")

MIS_MODES = {
    "one": 0,
    "balance": 1,
    "max": 2,
    "power2": 3,
    "geometryClamp": 4,
    "geometryBrdfClamp": 5,
}

FRAME_MODES = ("accumulate", "cleareveryframe")


@dataclass
class TechniqueParams:
    """Normalized technique block (the reference's defaults)."""
    technique: str                      # pt | photonfam | lvcphotonfam
    rng_offset: int = 0
    num_max_iteration: int = -1
    time_limit_ms: float = -1.0
    frame_mode: str = "accumulate"
    use_jitter: bool = True
    use_stat: bool = False
    stat_filename: str = ""
    write_every_frame: bool = False
    num_max_bounces: int = 3
    num_light_paths: int = 0
    num_vpl_light_paths: int = 0
    radius_percentage: float = 0.0
    mis_mode: int = MIS_MODES["balance"]
    clamping_coeff: float | None = None      # None -> auto 1/totalArea
    do_progressive: bool = False
    alpha_progressive: float = 0.7
    force_vsl: bool = False
    combined_filename: str = ""
    weighted_photon_filename: str = ""
    weighted_vpl_filename: str = ""
    run_passes: dict = field(default_factory=lambda: {
        "deferredShading": True, "lightTracing": True, "vplSplat": True,
        "photonSplat": True, "lightRender": True, "finalize": True,
    })


@dataclass
class RenderJob:
    scene: SceneData
    width: int
    height: int
    params: TechniqueParams
    raw: dict


def parse_technique(tech: str, j: dict) -> TechniqueParams:
    if "clampingStart" in j:
        raise ValueError("clampingStart option is not used anymore; remove it")
    p = TechniqueParams(technique=tech)
    p.rng_offset = int(j.get("rngOffset", 0))
    p.num_max_iteration = int(j.get("numMaxIteration", -1))
    p.time_limit_ms = float(j.get("timeLimitMs", -1.0))
    p.frame_mode = str(j.get("frameMode", "accumulate")).lower()
    if p.frame_mode not in FRAME_MODES:
        raise ValueError(f"unknown frameMode {p.frame_mode}")
    p.use_jitter = bool(j.get("useJitter", True))
    p.use_stat = bool(j.get("useStat", False))
    p.stat_filename = str(j.get("statFilename", ""))
    p.write_every_frame = bool(j.get("writeEveryFrame", False))
    p.num_max_bounces = int(j.get("numMaxBounces", 3))

    if tech == "pt":  # path tracing is not ported yet; the CLI refuses it
        return p

    p.num_light_paths = int(j.get("numLightPaths", 0))
    p.num_vpl_light_paths = int(j.get("numVplLightPaths", 0))
    p.radius_percentage = float(j.get("radiusPercentage", 0.0))
    p.mis_mode = MIS_MODES[j["misMode"]] if "misMode" in j else MIS_MODES["balance"]
    if "clampingCoeff" in j:
        p.clamping_coeff = float(j["clampingCoeff"])
    p.do_progressive = bool(j.get("DoProgressive", False))
    p.alpha_progressive = float(j.get("AlphaProgressive", 0.7))
    p.combined_filename = str(j.get("combinedFilename", ""))
    p.weighted_photon_filename = str(j.get("weightedPhotonFilename", ""))
    p.weighted_vpl_filename = str(j.get("weightedVplFilename", ""))
    if "run" in j:
        for k in p.run_passes:
            if k in j["run"]:
                p.run_passes[k] = bool(j["run"][k])
    # 0 VPL paths disables the VPL splat, as in the reference
    if p.num_vpl_light_paths == 0:
        p.run_passes["vplSplat"] = False
    # VSL is not ported yet: the frame refuses force_vsl
    p.force_vsl = tech == "photonfam" and bool(j.get("forceVsl", False))
    return p


def load_config(path: str, device="cuda") -> RenderJob:
    """Load a reference-format JSON config and its OBJ scene onto device."""
    with open(path) as f:
        cfg = json.load(f)
    base = os.path.dirname(os.path.abspath(path))
    width = int(cfg["resX"])
    height = int(cfg["resY"])

    positions, indices, kds, kss, nss = [], [], [], [], []
    for obj_rel in cfg["scene"]:
        meshes, materials = load_obj(os.path.join(base, obj_rel))
        for m in meshes:
            mat = materials[m.material]
            positions.append(m.positions)
            indices.append(m.indices)
            kds.append(mat.kd)
            kss.append(mat.ks)
            nss.append(mat.ns)

    light_cfg = cfg["arealight"]
    lmeshes, _ = load_obj(os.path.join(base, light_cfg["obj"]))
    # the reference asserts a single light mesh; several are merged
    lpos = np.concatenate([m.positions for m in lmeshes])
    offsets = np.cumsum([0] + [m.positions.shape[0] for m in lmeshes[:-1]])
    lidx = np.concatenate([m.indices + o for m, o in zip(lmeshes, offsets)])
    intensity = np.asarray(light_cfg["intensity"], np.float32)

    cam_json = cfg.get("camera", cfg.get("stablecamera"))
    if cam_json is None:
        raise ValueError("config needs camera or stablecamera")
    camera = Camera.from_json(cam_json, aspect=width / height)

    scene = build_scene(positions, indices, kds, kss, nss, lpos, lidx,
                        intensity, camera, device=device)
    tech = next((k for k in TECHNIQUE_KEYS if k in cfg), None)
    if tech is None:
        raise ValueError(f"config must contain one of {TECHNIQUE_KEYS}")
    return RenderJob(scene=scene, width=width, height=height,
                     params=parse_technique(tech, cfg[tech]), raw=cfg)
