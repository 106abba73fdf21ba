"""The port's VSL gather against the JAX package's, on the CPU.

Every input is made from a seed with numpy and handed to both packages.

* `seeds_from_key`: equal words (array_equal); `square_to_solid_angle` and
  `lambert_pdf_w_nopi`: rtol 1e-6 (last-ulp differences between XLA's and
  PyTorch's CPU sin / cos / sqrt).  The cone warp's x and y also get atol
  2e-6: near the cone's axis l = sqrt(1 - z^2) is small and multiplies a
  1-ulp difference of cos(half) by z / l (measured: 1.5e-6 on 6 of 1536
  values).
* The sample loop of one group (N = 1024 pixels, G = 4 records, 7 black
  pixels, ~80% gates): the port's plain `vsl_sample_group` against the JAX
  Pallas kernel in interpret mode and against JAX `vsl._sample_record`
  summed over the group, at rtol 2e-4, atol 2e-5, the tolerance the JAX
  package holds its own kernel to against its XLA step
  (tests/test_vsl_kernel.py).  Both draw the same pcg4d numbers, so only
  ulps of sin / cos / pow separate them; no pixel falls outside.  The same
  against both references for a group with every lobe case the Hopper
  kernel branches on (tests/torch_vsl_cases.py: diffuse walls with
  ks = 0 and ns = 0, green-only phong, kd = 0, black pixels and a black
  record, G = 7), in which each of the three strategies contributes.
* `vsl_gather` on the Cornell box at 32x32 (16 VSL paths, 3 records) from
  the JAX package's G-buffer and photon map: rtol 2e-4, atol 2e-6, as
  tests/test_vsl_kernel.py compares two VSL gathers.
* The wrapper takes its plain version on CPU tensors and refuses to launch
  the kernel on them; config and schedule carry the VSL radius as the JAX
  package's do."""
from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evplp_tpu.core import brdf as jbrdf
from evplp_tpu.core import mathutil as jmu
from evplp_tpu.core import rng as jrng
from evplp_tpu.core.sampling import iteration_key as jax_iteration_key
from evplp_tpu.integrators import gbuffer as jgb
from evplp_tpu.integrators import light_trace as jlt
from evplp_tpu.integrators import vsl as jvsl
from evplp_tpu.integrators import vsl_kernel as jvk
from evplp_tpu.runtime.loop import ProgressiveSchedule as JaxSchedule
from evplp_tpu.scene import procedural
from evplp_tpu.scene.config import parse_technique_json as jax_parse_technique
from evplp_tpu_torch.core import brdf, rng
from evplp_tpu_torch.core import mathutil as mu
from evplp_tpu_torch.core.sampling import iteration_key
from evplp_tpu_torch.integrators import gbuffer, light_trace, vsl, vsl_kernel
from evplp_tpu_torch.runtime.loop import ProgressiveSchedule
from evplp_tpu_torch.scene.config import parse_technique
from tests.test_torch_scene import torch_scene_of
from tests.torch_vsl_cases import mixed_lobe_group, strategy_counter

SEED0, SEED1, REC_BASE = 0xDEADBEEF, 17, 3


def port_of(cls, obj):
    """The port's dataclass `cls` holding the JAX object's fields (CPU)."""
    return cls(**{f.name: torch.from_numpy(np.array(getattr(obj, f.name)))
                  for f in fields(cls)})


def _unit(rs, k):
    v = rs.normal(size=(k, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_seeds_from_key(seed):
    jkey = jax_iteration_key(seed, 2)
    want = [np.asarray(x) for x in jrng.seeds_from_key(jkey)]
    got = rng.seeds_from_key(iteration_key(seed, 2, "cpu"))
    np.testing.assert_array_equal([int(x) for x in got],
                                  [int(x) for x in want])


def test_cone_warp_and_lambert_pdf_nopi():
    rs = np.random.default_rng(1)
    u = rs.uniform(size=(512, 2)).astype(np.float32)
    half = rs.uniform(0.0, np.pi / 2, 512).astype(np.float32)
    got = mu.square_to_solid_angle(torch.from_numpy(u),
                                   torch.from_numpy(half)).numpy()
    want = np.asarray(jmu.square_to_solid_angle(jnp.asarray(u),
                                                jnp.asarray(half)))
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-6)
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=1e-6, atol=2e-6)
    n, v = _unit(rs, 512), rs.normal(size=(512, 3)).astype(np.float32)
    got = brdf.lambert_pdf_w_nopi(torch.from_numpy(n), torch.from_numpy(v))
    want = jbrdf.lambert_pdf_w_nopi(jnp.asarray(n), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert (got.numpy() > 0).mean() > 0.3


@pytest.fixture(scope="module")
def group():
    """One group of G = 4 records over N = 1024 pixels, from numpy."""
    rs = np.random.default_rng(0)
    n, g = 1024, 4
    kd = rs.uniform(0, 0.6, (n, 3)).astype(np.float32)
    ks = rs.uniform(0, 0.3, (n, 3)).astype(np.float32)
    kd[:7] = 0.0          # black pixels exercise the black1 gate
    ks[:7] = 0.0
    px = dict(position=rs.uniform(-2, 2, (n, 3)).astype(np.float32),
              normal=_unit(rs, n), kd=kd, ks=ks,
              ns=rs.uniform(1, 64, n).astype(np.float32),
              stencil=np.ones(n, np.float32), hit_light=np.zeros(n, bool))
    recs = dict(pos=rs.uniform(-3, 3, (g, 3)).astype(np.float32),
                normal=_unit(rs, g), flux_dir=_unit(rs, g),
                flux=rs.uniform(0, 2, (g, 3)).astype(np.float32),
                kd=rs.uniform(0, 0.7, (g, 3)).astype(np.float32),
                ks=rs.uniform(0, 0.3, (g, 3)).astype(np.float32),
                ns=rs.uniform(1, 32, g).astype(np.float32),
                p_select=np.zeros(g, np.float32),
                flags=np.full(g, jlt.FLAG_VPL, np.int32))
    gates = rs.uniform(size=(g, n)) < 0.8
    mask = np.zeros(n, np.int32)
    for i in range(g):
        mask |= gates[i].astype(np.int32) << i
    cam = np.asarray([0.0, 0.0, 6.0], np.float32)
    return dict(n=n, g=g, px=px, recs=recs, gates=gates, mask=mask, cam=cam,
                pids=np.arange(n, dtype=np.int32) + 1000,
                radius=np.float32(0.4))


def _port_group(s):
    """The port's plain vsl_sample_group on the fixture's group."""
    tg = gbuffer.GBuffer(**{k: torch.from_numpy(v) for k, v in s["px"].items()})
    wi10 = mu.normalize(torch.from_numpy(s["cam"])[None] - tg.position)
    trecs = {k: torch.from_numpy(v) for k, v in s["recs"].items()}
    r = torch.tensor(s["radius"])
    inv_pi_r2 = torch.tensor(mu.INV_PI, dtype=torch.float32) / (r * r)
    cos_half, counts = vsl_kernel.ctx_planes(tg.position, trecs["pos"], r)
    before = vsl_kernel.launches
    out = vsl_kernel.vsl_sample_group(
        vsl_kernel.pack_pixels(tg.position, tg.normal, tg.kd, tg.ks, tg.ns,
                               wi10),
        torch.from_numpy(s["pids"]), torch.from_numpy(s["mask"]), cos_half,
        counts, vsl_kernel.pack_records(trecs, inv_pi_r2), SEED0, SEED1,
        REC_BASE)
    assert vsl_kernel.launches == before      # CPU tensors: no launch
    return out.numpy(), (tg, wi10, trecs, r, inv_pi_r2)


def _jax_gbuf(s):
    return jgb.GBuffer(**{k: jnp.asarray(v) for k, v in s["px"].items()})


def _jax_pallas_group(s):
    """The JAX Pallas kernel, in interpret mode, on the group s: (N, 3)."""
    jvk.set_interpret(True)
    jg = _jax_gbuf(s)
    wi10 = jmu.normalize(jnp.asarray(s["cam"])[None] - jg.position)
    radius = jnp.float32(s["radius"])
    jrecs = {k: jnp.asarray(v) for k, v in s["recs"].items()}
    cosh, cnts = jvk.ctx_planes(jg.position, jrecs["pos"], radius)
    out = jvk.vsl_sample_group(
        jvk.pack_pixels(jg.position, jg.normal, jg.kd, jg.ks, jg.ns, wi10),
        jnp.asarray(s["pids"]).reshape(-1, 128),
        jnp.asarray(s["mask"]).reshape(-1, 128), cosh, cnts,
        jvk.pack_records(jrecs, jmu.INV_PI / (radius * radius)),
        jnp.asarray([np.uint32(SEED0).view(np.int32), SEED1, REC_BASE],
                    jnp.int32),
        jnp.asarray([radius]), group=s["g"], rows=8)
    return np.stack([np.asarray(out[c]).reshape(-1) for c in range(3)], -1)


def _jax_sample_record_sum(s):
    """JAX vsl._sample_record summed over the group s: (N, 3)."""
    jg = _jax_gbuf(s)
    wi10 = jmu.normalize(jnp.asarray(s["cam"])[None] - jg.position)
    radius = jnp.float32(s["radius"])
    want = jnp.zeros((s["n"], 3))
    for i in range(s["g"]):
        rec = {k: jnp.asarray(v[i]) for k, v in s["recs"].items()}
        rng_ctx = (jnp.uint32(SEED0), jnp.uint32(SEED1),
                   jnp.asarray(s["pids"]), jnp.int32(REC_BASE + i))
        want = want + jvsl._sample_record(
            jg, rec, jnp.asarray(s["gates"][i]), rng_ctx, radius,
            jmu.INV_PI / (radius * radius), wi10)
    return np.asarray(want)


def test_sample_group_matches_jax_pallas_kernel(group):
    s = group
    got, _ = _port_group(s)
    want = _jax_pallas_group(s)
    assert np.abs(want).max() > 0.0
    assert (want[:7] == 0.0).all() and (got[:7] == 0.0).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_sample_group_matches_jax_sample_record(group):
    s = group
    got, (tg, twi10, trecs, r, inv_pi_r2) = _port_group(s)
    want = _jax_sample_record_sum(s)
    per_record = torch.zeros((s["n"], 3))
    for i in range(s["g"]):
        per_record = per_record + vsl._sample_record(
            tg, {k: v[i] for k, v in trecs.items()},
            torch.from_numpy(s["gates"][i]),
            (SEED0, SEED1, torch.from_numpy(s["pids"]), REC_BASE + i), r,
            inv_pi_r2, twi10)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # the per-record path and the group path are one computation
    np.testing.assert_allclose(per_record.numpy(), got, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def mixed_group():
    """G = 7 records over N = 1024 pixels with every lobe case the
    kernel branches on (tests/torch_vsl_cases.py)."""
    return mixed_lobe_group()


@pytest.mark.parametrize("reference", ["pallas_interpret", "sample_record"])
def test_mixed_lobe_group_matches_jax(mixed_group, reference):
    s = mixed_group
    got, _ = _port_group(s)
    want = (_jax_pallas_group(s) if reference == "pallas_interpret"
            else _jax_sample_record_sum(s))
    assert np.abs(want).max() > 0.0
    assert (want[:3] == 0.0).all() and (got[:3] == 0.0).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_mixed_lobe_group_takes_every_strategy(mixed_group):
    """Each strategy's guard holds on some sample of the mixed group, on
    pairs of every lobe case."""
    s = mixed_group
    observe, counts = strategy_counter()
    _, (tg, wi10, trecs, r, inv_pi_r2) = _port_group(s)
    cos_half, num = vsl_kernel.ctx_planes(tg.position, trecs["pos"], r)
    vsl_kernel.vsl_sample_group_plain(
        vsl_kernel.pack_pixels(tg.position, tg.normal, tg.kd, tg.ks, tg.ns,
                               wi10),
        torch.from_numpy(s["pids"]), torch.from_numpy(s["mask"]), cos_half,
        num, vsl_kernel.pack_records(trecs, inv_pi_r2), SEED0, SEED1,
        REC_BASE, observe=observe)
    assert min(counts.values()) > 0, counts
    ks, rks = s["px"]["ks"], s["recs"]["ks"]
    for kss in (ks, rks):
        assert (kss == 0).all(1).any()                       # no phong
        assert ((kss[:, 0] == 0) & (kss[:, 1] > 0)).any()   # ks.x-only pdf
    assert ((s["px"]["kd"] == 0).all(1) & (ks > 0).all(1)).any()
    assert ((s["recs"]["kd"] == 0).all(1) & (rks == 0).all(1)).any()


def test_wrapper_dispatch_and_checks(group):
    s = group
    _, (tg, wi10, trecs, r, inv_pi_r2) = _port_group(s)
    pix = vsl_kernel.pack_pixels(tg.position, tg.normal, tg.kd, tg.ks, tg.ns,
                                 wi10)
    cos_half, counts = vsl_kernel.ctx_planes(tg.position, trecs["pos"], r)
    table = vsl_kernel.pack_records(trecs, inv_pi_r2)
    args = [pix, torch.from_numpy(s["pids"]), torch.from_numpy(s["mask"]),
            cos_half, counts, table, SEED0, SEED1, REC_BASE]
    with pytest.raises(ValueError, match="CUDA"):
        vsl_kernel.vsl_sample_group_cuda(*args)
    bad = list(args)
    bad[4] = counts.to(torch.int64)
    with pytest.raises(TypeError):
        vsl_kernel.vsl_sample_group(*bad)
    bad = list(args)
    bad[3] = cos_half[:, :-1]
    with pytest.raises(ValueError, match="shape"):
        vsl_kernel.vsl_sample_group(*bad)
    assert table.shape == (s["g"], vsl_kernel.NREC_F)
    assert int(counts.max()) <= vsl_kernel.MAX_VSL_SAMPLES


def test_vsl_gather_matches_jax():
    js = procedural.cornell_box()
    ts = torch_scene_of(js)
    res, paths = 32, 16
    jg = jgb.trace_gbuffer(js, res, res)
    jpm = jlt.trace_light_paths(js, jax_iteration_key(7, 0), paths, 3)
    r = np.float32(0.08)
    want = np.asarray(jvsl.vsl_gather(js, jg, jpm, jax_iteration_key(8, 0),
                                      jnp.float32(r), paths))
    got = vsl.vsl_gather(ts, port_of(gbuffer.GBuffer, jg),
                         port_of(light_trace.PhotonMap, jpm),
                         iteration_key(8, 0, "cpu"), r, paths).numpy()
    assert want.max() > 0.0
    assert np.isfinite(got).all() and (got >= 0.0).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-6)


def test_config_and_schedule_carry_the_vsl_radius():
    block = dict(numLightPaths=100, numVplLightPaths=100, forceVsl=True,
                 vslRadiusPercentage=0.05, DoProgressive=True,
                 AlphaProgressive=0.7)
    p = parse_technique("photonfam", block)
    jp = jax_parse_technique("photonfam", block)
    assert p.force_vsl and p.vsl_radius_percentage == jp.vsl_radius_percentage
    missing = {k: v for k, v in block.items() if k != "vslRadiusPercentage"}
    for parse in (parse_technique, jax_parse_technique):
        with pytest.raises(KeyError):
            parse("photonfam", missing)
    for vsl0 in (0.151, 0.01, 0.0):
        args = (0.01, 0.5, 0.7, 100, 100, vsl0)
        ours, ref = ProgressiveSchedule(*args), JaxSchedule(*args)
        for it in range(1, 40):
            ours.update(it)
            ref.update(it)
            assert ours.vsl_radius == ref.vsl_radius
            assert ours.radius == ref.radius
    assert ours.vsl_radius == 0.0
