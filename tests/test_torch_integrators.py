"""The port's integrators against the JAX package's at 16x16 on the
procedural box_field (200 boxes, so every ray cast goes through the BVH
traversal).  Each module gets the JAX package's own inputs (scene, G-buffer,
photon map, as numpy arrays) so a mismatch points at that module.

Tolerance: rtol 1e-4, atol 1e-5.  The two packages evaluate the same float
formulas, but XLA and PyTorch differ in transcendental kernels (pow, sin,
cos, rsqrt) in the last ulps and sum in different orders; atomics and the
tile sort change the binned splat's float order against the dense oracle."""
from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evplp_tpu.core.sampling import iteration_key as jax_iteration_key
from evplp_tpu.integrators import gbuffer as jgb
from evplp_tpu.integrators import light_trace as jlt
from evplp_tpu.integrators import photon_splat as jps
from evplp_tpu.integrators import vpl as jvpl
from evplp_tpu.scene import procedural
from evplp_tpu_torch.core.sampling import iteration_key
from evplp_tpu_torch.integrators import gbuffer, light_trace, photon_splat, vpl
from tests.test_torch_scene import torch_scene_of

RES = 16
PATHS = 64
RECORDS = 4
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def setup():
    js = procedural.box_field(num_boxes=200)
    ts = torch_scene_of(js)
    jitter = np.asarray([0.013, -0.021], np.float32)
    jg = jgb.trace_gbuffer(js, RES, RES, jnp.asarray(jitter))
    jpm = jlt.trace_light_paths(js, jax_iteration_key(0, 5), PATHS, RECORDS)
    tg = gbuffer.GBuffer(**{f.name: torch.from_numpy(np.array(getattr(
        jg, f.name))) for f in fields(gbuffer.GBuffer)})
    tpm = light_trace.PhotonMap(**{f.name: torch.from_numpy(np.array(getattr(
        jpm, f.name))) for f in fields(light_trace.PhotonMap)})
    radius = js.bounding_radius * 0.05
    return dict(js=js, ts=ts, jitter=jitter, jg=jg, jpm=jpm, tg=tg, tpm=tpm,
                radius=radius, clamp=1.0 / js.total_area,
                pdf_mc=(8 / PATHS) / np.pi / radius ** 2)


def _close(port, ref, what):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def test_trace_gbuffer_and_light_image(setup):
    s = setup
    tg = gbuffer.trace_gbuffer(s["ts"], RES, RES,
                               torch.from_numpy(s["jitter"]))
    for f in fields(gbuffer.GBuffer):
        _close(getattr(tg, f.name), getattr(s["jg"], f.name), f.name)
    assert tg.stencil.sum() > RES * RES / 2
    _close(gbuffer.light_image(s["ts"], tg),
           jgb.light_image(s["js"], s["jg"]), "light_image")
    z = gbuffer.zero_gbuffer(RES * RES, "cpu")
    assert not z.stencil.any() and not z.hit_light.any()


def test_trace_light_paths(setup):
    s = setup
    tpm = light_trace.trace_light_paths(
        s["ts"], iteration_key(0, 5, "cpu"), PATHS, RECORDS)
    np.testing.assert_array_equal(tpm.flags.numpy(), np.asarray(
        s["jpm"].flags))
    for f in fields(light_trace.PhotonMap):
        _close(getattr(tpm, f.name), getattr(s["jpm"], f.name), f.name)
    assert (tpm.flags.numpy()[:, 1] != 0).mean() > 0.5


@pytest.mark.parametrize("mis_mode", range(6))
def test_vpl_gather_all_mis_modes(setup, mis_mode):
    s = setup
    ref = jvpl.vpl_gather(s["js"], s["jg"], s["jpm"], mis_mode,
                          jnp.float32(s["pdf_mc"]), jnp.float32(s["clamp"]),
                          num_vpl_paths=8)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    out = vpl.vpl_gather(s["ts"], s["tg"], s["tpm"], mis_mode,
                         f32(s["pdf_mc"]), f32(s["clamp"]), num_vpl_paths=8,
                         chunk=5)
    assert np.abs(np.asarray(ref)).max() > 0.0
    _close(out, ref, f"vpl mis {mis_mode}")


@pytest.mark.parametrize("mis_mode", [0, 1, 4, 5])
def test_binned_splat_matches_dense_oracle(setup, mis_mode):
    s = setup
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    args = (s["radius"], mis_mode, s["pdf_mc"], s["clamp"], 1.0 / PATHS)
    ref = jps.photon_splat_dense(s["js"], s["jg"], s["jpm"],
                                 *(jnp.float32(a) if isinstance(a, float)
                                   else a for a in args))
    targs = (f32(s["radius"]), mis_mode, f32(s["pdf_mc"]), f32(s["clamp"]),
             1.0 / PATHS)
    dense = photon_splat.photon_splat_dense(s["ts"], s["tg"], s["tpm"],
                                            *targs)
    _close(dense, ref, "dense vs JAX dense")
    binned, dropped = photon_splat.photon_splat_binned(
        s["ts"], s["tg"], s["tpm"], *targs, RES, RES,
        torch.from_numpy(s["jitter"]), tile=4)
    assert int(dropped) == 0
    assert np.abs(np.asarray(ref)).max() > 0.0
    _close(binned, ref, "binned vs JAX dense")
