"""A VSL sample group with every lobe case the port's sample kernel
branches on, made with numpy; shared by the CPU comparison with the JAX
package (tests/test_torch_vsl.py) and the card test of the kernel
(tests/test_torch_cuda.py).

Pixels and records come in thirds: diffuse (ks == 0, ns == 0, as
box_field's walls), green-only phong (ks = (0, 0.2, 0): the phong pdf gates
on ks.x alone, so its pdf is 0 while its value is not) and phong without a
lambert lobe (kd == 0, ks > 0).  The first 3 pixels and the last record are
black, and the radius is wide enough that a BRDF-sampled direction falls in
the cone often, so both BRDF strategies contribute."""
import numpy as np

from evplp_tpu_torch.integrators.light_trace import FLAG_VPL


def _unit(rs, k):
    v = rs.normal(size=(k, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _lobes(rs, k):
    """kd, ks, ns of k surfaces, by thirds: diffuse, green-only phong, phong
    with kd == 0."""
    kind = np.arange(k) % 3
    kd = rs.uniform(0.1, 0.7, (k, 3)).astype(np.float32)
    ks = rs.uniform(0.05, 0.3, (k, 3)).astype(np.float32)
    ns = rs.uniform(1, 64, k).astype(np.float32)
    ks[kind == 0] = 0.0
    ns[kind == 0] = 0.0
    ks[kind == 1] = np.float32([0.0, 0.2, 0.0])
    kd[kind == 2] = 0.0
    return kd, ks, ns


def mixed_lobe_group(n=1024, g=7, seed=11) -> dict:
    """Pixel fields (position, normal, kd, ks, ns, stencil, hit_light),
    record fields (pos, normal, flux_dir, flux, kd, ks, ns, p_select,
    flags), gates (g, n) with ~80% set, their bit mask, the camera, the
    pixel ids and the radius."""
    rs = np.random.default_rng(seed)
    kd, ks, ns = _lobes(rs, n)
    kd[:3] = ks[:3] = 0.0
    px = dict(position=rs.uniform(-1, 1, (n, 3)).astype(np.float32),
              normal=_unit(rs, n), kd=kd, ks=ks, ns=ns,
              stencil=np.ones(n, np.float32), hit_light=np.zeros(n, bool))
    rkd, rks, rns = _lobes(rs, g)
    rkd[-1] = rks[-1] = 0.0
    recs = dict(pos=rs.uniform(-1.5, 1.5, (g, 3)).astype(np.float32),
                normal=_unit(rs, g), flux_dir=_unit(rs, g),
                flux=rs.uniform(0, 2, (g, 3)).astype(np.float32),
                kd=rkd, ks=rks, ns=rns, p_select=np.zeros(g, np.float32),
                flags=np.full(g, FLAG_VPL, np.int32))
    gates = rs.uniform(size=(g, n)) < 0.8
    mask = np.zeros(n, np.int32)
    for i in range(g):
        mask |= gates[i].astype(np.int32) << i
    return dict(n=n, g=g, px=px, recs=recs, gates=gates, mask=mask,
                cam=np.asarray([0.0, 0.0, 4.0], np.float32),
                pids=np.arange(n, dtype=np.int32) + 500,
                radius=np.float32(0.6))


def strategy_counter():
    """(observe, counts): an observer for vsl_sample_group_plain that
    counts, over the gated pairs' live samples, those in which each
    strategy's guard holds."""
    counts = dict(cone=0, eye_brdf=0, light_brdf=0)

    def observe(live, cone, eye_brdf, light_brdf, **_):
        for k, m in (("cone", cone), ("eye_brdf", eye_brdf),
                     ("light_brdf", light_brdf)):
            counts[k] += int((live & m).sum())
    return observe, counts
