"""Scene export (counterpart of the JAX package's `scene/export.py`):
write procedural scenes as OBJ/MTL + JSON configs in the reference's
on-disk format, so the whole config -> OBJ loader -> renderer pipeline runs
without the reference's assets.

`write_reference_matrix` generates the shipped `configs/` tree: 10
technique variants per scene (pt/pm/vpl/vsl/ours, each with a _progressive
twin) with the reference's own parameters (300k light paths, 30 VPL paths,
15 s equal-time, 1280x720).  Every file equals the JAX package's byte for
byte; texture PNGs are written by `utils/png.py` (zlib, no PIL).

Write it with:  python -m evplp_tpu_torch.scene.export OUT_DIR
"""
from __future__ import annotations

import json
import os

import numpy as np

from evplp_tpu_torch.utils.png import write_png_rgb


def _write_obj(path: str, groups, mtl_name: str):
    """groups: list of (material_name, positions (V,3), indices (T,3))
    or (..., uv (V,2)) — with uv, faces are written as v/vt pairs."""
    with open(path, "w") as f:
        f.write(f"mtllib {mtl_name}\n")
        v_off = 1
        vt_off = 1
        for g in groups:
            name, pos, idx = g[0], g[1], g[2]
            uv = g[3] if len(g) > 3 else None
            f.write(f"o {name}\n")
            np.savetxt(f, np.asarray(pos, np.float64), fmt="v %.6f %.6f %.6f")
            f.write(f"usemtl {name}\n")
            idx = np.asarray(idx, np.int64)
            if uv is None:
                np.savetxt(f, idx + v_off, fmt="f %d %d %d")
            else:
                np.savetxt(f, np.asarray(uv, np.float64), fmt="vt %.6f %.6f")
                for t in idx:
                    f.write("f " + " ".join(
                        f"{v + v_off}/{v + vt_off}" for v in t) + "\n")
                vt_off += len(uv)
            v_off += len(pos)


def _write_mtl(path: str, mats):
    """mats: list of (name, kd, ks, ns[, map_kd]) — ns written PRE-division
    (the loader divides by 4 like Assimp, rtcommon.h:55-64)."""
    with open(path, "w") as f:
        for m in mats:
            name, kd, ks, ns = m[0], m[1], m[2], m[3]
            f.write(f"newmtl {name}\n")
            f.write(f"Kd {kd[0]} {kd[1]} {kd[2]}\n")
            f.write(f"Ks {ks[0]} {ks[1]} {ks[2]}\n")
            f.write(f"Ns {ns * 4.0}\n")
            if len(m) > 4 and m[4]:
                f.write(f"map_Kd {m[4]}\n")
            f.write("\n")


def write_spec_obj(out_dir: str, name: str, spec: dict):
    """Write a procedural spec (scene/procedural.py) as <name>.obj/.mtl +
    <name>_lights.obj/.mtl (+ texture PNGs for groups with map_kd);
    returns the two OBJ paths."""
    os.makedirs(out_dir, exist_ok=True)
    tex_files = {}
    for tname, img in spec.get("textures", {}).items():
        fn = f"{name}_{tname}.png"
        arr = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
        # the loader flips vertically on read; pre-flip so a config-loaded
        # scene matches the in-memory spec build
        write_png_rgb(os.path.join(out_dir, fn),
                      (arr[::-1] * 255.0 + 0.5).astype(np.uint8))
        tex_files[tname] = fn

    groups, mats = [], []
    for g in spec["groups"]:
        extra = g[6] if len(g) > 6 else {}
        uv = extra.get("uv")
        groups.append((g[0], g[1], g[2]) + ((uv,) if uv is not None else ()))
        mats.append((g[0], g[3], g[4], g[5],
                     tex_files.get(extra.get("map_kd"))))

    obj = os.path.join(out_dir, f"{name}.obj")
    _write_obj(obj, groups, f"{name}.mtl")
    _write_mtl(os.path.join(out_dir, f"{name}.mtl"), mats)

    lpos, lidx = spec["light"]
    lobj = os.path.join(out_dir, f"{name}_lights.obj")
    _write_obj(lobj, [("light", np.asarray(lpos), np.asarray(lidx))],
               f"{name}_lights.mtl")
    _write_mtl(os.path.join(out_dir, f"{name}_lights.mtl"),
               [("light", (0, 0, 0), (0, 0, 0), 0.0)])
    return obj, lobj


def write_spec_config(out_dir: str, scene_name: str, spec: dict,
                      technique: str, block: dict, cfg_name: str,
                      res_x: int, res_y: int,
                      write_objs: bool = True) -> str:
    """Write a reference-format JSON config (+ the scene OBJs once)."""
    if write_objs:
        write_spec_obj(out_dir, scene_name, spec)
    cfg = {
        "resX": res_x,
        "resY": res_y,
        "scene": [f"{scene_name}.obj"],
        "arealight": {"obj": f"{scene_name}_lights.obj",
                      "intensity": list(spec["intensity"])},
        "camera": dict(spec["camera"]),
        technique: block,
    }
    path = os.path.join(out_dir, f"{cfg_name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)
    return path


def technique_block(variant: str, scene: str, progressive: bool,
                    time_limit_ms: float = 15000.0) -> tuple[str, dict]:
    """The reference's per-variant technique blocks, parameters verbatim
    from scene/conference/conference_<variant>[_progressive].json."""
    suffix = "_progressive" if progressive else ""
    out = f"out/{scene}_{variant}{suffix}"
    common = {
        "rngOffset": 0,
        "numMaxIteration": -1,
        "timeLimitMs": time_limit_ms,
        "frameMode": "accumulate",
        "statFilename": f"{out}_stat.json",
        "useJitter": True,
        "useStat": True,
        "numMaxBounces": 3,
        "DoProgressive": progressive,
        "AlphaProgressive": 0.7,
    }
    if variant == "pt":
        return "pt", {**common,
                      "outputFilename": f"{out}.pfm",
                      "numSamplePerPixel": 1}
    pf = {**common,
          "combinedFilename": f"{out}.pfm",
          "weightedPhotonFilename": f"{out}_weightedpm.pfm",
          "weightedVplFilename": f"{out}_weightedvpl.pfm"}
    if variant == "pm":
        pf.update(renderMode="pm", misMode="one", numLightPaths=300000,
                  numVplLightPaths=0, radiusPercentage=0.003)
    elif variant == "vpl":
        pf.update(renderMode="vpl", misMode="one", numLightPaths=30,
                  numVplLightPaths=30, radiusPercentage=0.0,
                  clampingCoeff=1.0)
    elif variant == "vsl":
        pf.update(forceVsl=True, vslRadiusPercentage=0.05, renderMode="vpl",
                  misMode="one", numLightPaths=100, numVplLightPaths=100,
                  radiusPercentage=0.0)
    elif variant == "ours":
        pf.update(renderMode="vplpm", numLightPaths=300000,
                  numVplLightPaths=30, radiusPercentage=0.003)
    else:
        raise ValueError(f"unknown variant {variant}")
    return "photonfam", pf


VARIANTS = ("pt", "pm", "vpl", "vsl", "ours")


def write_scene_matrix(out_dir: str, scene: str, spec: dict,
                       res=(1280, 720),
                       time_limit_ms: float = 15000.0) -> list[str]:
    """One scene's 10 variant configs (+ OBJs once) under
    <out_dir>/<scene>/."""
    scene_dir = os.path.join(out_dir, scene)
    paths = []
    first = True
    for variant in VARIANTS:
        for progressive in (False, True):
            suffix = "_progressive" if progressive else ""
            tech, block = technique_block(variant, scene, progressive,
                                          time_limit_ms)
            paths.append(write_spec_config(
                scene_dir, scene, spec, tech, block,
                f"{scene}_{variant}{suffix}", res[0], res[1],
                write_objs=first))
            first = False
    return paths


def write_box_field_big(out_dir: str, res=(512, 512)) -> list[str]:
    """Generate the ~300k-triangle quality scene on demand (the OBJ is
    ~17 MB, so it is not committed).  512x512: the reduced-resolution GT
    protocol for the fused-node layout."""
    from evplp_tpu_torch.scene.procedural import box_field_big_spec
    return write_scene_matrix(out_dir, "box_field_big",
                              box_field_big_spec(), res)


def write_reference_matrix(out_dir: str, res=(1280, 720),
                           time_limit_ms: float = 15000.0) -> list[str]:
    """The shipped configs/ tree: 4 scenes x 10 variants, reference
    protocol parameters (reference: scene/{conference,livingroom,buddha},
    10 configs each; livingroom here exercises map_Kd end-to-end)."""
    from evplp_tpu_torch.scene.procedural import (box_field_spec, cornell_spec,
                                            glossy_spec, livingroom_spec)
    specs = {
        "cornell": cornell_spec(),
        "glossy": glossy_spec(),
        "box_field": box_field_spec(),
        "livingroom": livingroom_spec(),
    }
    paths = []
    for scene, spec in specs.items():
        paths.extend(write_scene_matrix(out_dir, scene, spec, res,
                                        time_limit_ms))
    return paths


# ---- Cornell helpers used by tests ----

def write_cornell_obj(out_dir: str, glossy_exponent: float = 30.0):
    """Write the procedural Cornell box as cornell.obj/.mtl +
    cornell_lights.obj/.mtl; returns the two OBJ paths."""
    from evplp_tpu_torch.scene.procedural import cornell_spec
    return write_spec_obj(out_dir, "cornell",
                          cornell_spec(glossy_exponent=glossy_exponent))


def write_cornell_config(out_dir: str, technique_block: dict, technique: str,
                         res: int = 64, intensity=(12.0, 12.0, 12.0, 0.0),
                         name: str = "cornell") -> str:
    """Write a reference-format JSON config next to the cornell OBJs."""
    from evplp_tpu_torch.scene.procedural import cornell_spec
    spec = cornell_spec(light_intensity=intensity)
    return write_spec_config(out_dir, "cornell", spec, technique,
                             technique_block, name, res, res)


if __name__ == "__main__":
    import sys
    # the output directory is required: the shipped configs/ tree's PNGs
    # were written by PIL, and this writer's equal pixels compress to
    # other bytes
    if len(sys.argv) != 2:
        sys.exit("usage: python -m evplp_tpu_torch.scene.export OUT_DIR")
    for p in write_reference_matrix(sys.argv[1]):
        print(p)
