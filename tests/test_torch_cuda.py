"""The port's kernels on the card against their plain PyTorch versions: the
three traversal kernels (traverse.cu, packet7.cu, packet.cu) on the
box_field config's scene (24,010 triangles), and the VSL sample-loop kernel
on a random group of 8 records over 16,384 pixels made with numpy.  These tests need a CUDA card and skip elsewhere;
the file imports no JAX, so it runs on a machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerance: closest hits agree prim for prim or tie in t at rtol 1e-4, with t
at rtol 1e-5 (the kernel is built with -fmad=false and rounds as the plain
ops do); any-hit results are equal on live lanes.  The VSL kernel matches
its plain version at rtol 2e-4, atol 2e-5, the tolerance the JAX package
holds its own VSL kernel to."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from evplp_tpu_torch.core import mathutil as mu
from evplp_tpu_torch.integrators import vsl_kernel
from evplp_tpu_torch.scene.config import load_config
from evplp_tpu_torch.trace import packet, packet7, traverse

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "box_field", "box_field_ours.json")
N = 16384


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return load_config(CONFIG, device="cuda").scene


def _rays(scene, any_hit):
    gen = torch.Generator(device="cuda").manual_seed(7)
    lo = torch.tensor([0.2, 0.05, 0.2], device="cuda")
    hi = torch.tensor([3.8, 1.9, 3.8], device="cuda")
    o = lo + (hi - lo) * torch.rand((N, 3), generator=gen, device="cuda")
    d = torch.randn((N, 3), generator=gen, device="cuda")
    t_min = torch.full((N,), 1e-4, device="cuda")
    t_max = torch.full((N,), traverse.BIG, device="cuda")
    if any_hit:
        live = torch.rand((N,), generator=gen, device="cuda") < 0.5
        t_max = torch.where(live, 1.0 - 1e-4, 0.0)
    return scene.tris, scene.bvh, o, d, t_min, t_max, any_hit


# (module, dispatching wrapper, plain version) of each traversal kernel
TRAVERSALS = {
    "traverse": (traverse, traverse.traverse, traverse.traverse_plain),
    "packet7": (packet7, packet7.packet7_trace, packet7.packet7_plain),
    "packet": (packet, packet.packet_trace, packet.packet_plain),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(TRAVERSALS))
@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_matches_plain(scene, any_hit, kernel):
    mod, wrapper, plain = TRAVERSALS[kernel]
    args = _rays(scene, any_hit)
    before = mod.launches
    t_k, p_k, _, _ = wrapper(*args)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    t_p, p_p, _, _ = plain(*args)
    p_k, p_p = p_k.cpu().numpy(), p_p.cpu().numpy()
    if any_hit:
        live = (args[5] > args[4]).cpu().numpy()
        np.testing.assert_array_equal(p_k[live] >= 0, p_p[live] >= 0)
        return
    t_k, t_p = t_k.cpu().numpy(), t_p.cpu().numpy()
    assert ((p_k >= 0) == (p_p >= 0)).all()
    m = p_p >= 0
    assert ((p_k[m] == p_p[m]) | np.isclose(t_k[m], t_p[m], rtol=1e-4)).all()
    np.testing.assert_allclose(t_k, t_p, rtol=1e-5)
    assert m.mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("cuda_fn", [traverse.traverse_cuda,
                                     packet7.packet7_cuda,
                                     packet.packet_cuda])
def test_wrapper_rejects_bad_inputs(scene, cuda_fn):
    tris, bvh, o, d, t_min, t_max, _ = _rays(scene, False)
    with pytest.raises(TypeError):
        cuda_fn(tris, bvh, o.double(), d, t_min, t_max, False)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fn(tris, bvh, o.t().contiguous().t(), d, t_min, t_max, False)
    with pytest.raises(ValueError, match="shape"):
        cuda_fn(tris, bvh, o, d, t_min[:-1], t_max, False)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fn(tris, bvh, o.cpu(), d.cpu(), t_min.cpu(), t_max.cpu(), False)


@pytest.mark.cuda
def test_packet_wrappers_reject_bad_scenes(scene):
    tris, bvh, o, d, t_min, t_max, _ = _rays(scene, False)
    deep = dataclasses.replace(bvh, depth=packet.STACK_DEPTH)
    for fn in (packet7.packet7_cuda, packet.packet_cuda):
        with pytest.raises(ValueError, match="depth"):
            fn(tris, deep, o, d, t_min, t_max, False)
    unpacked = dataclasses.replace(bvh, pk_meta=bvh.pk_meta[:1])
    with pytest.raises(ValueError, match="packed layout"):
        packet7.packet7_cuda(tris, unpacked, o, d, t_min, t_max, False)
    with pytest.raises(TypeError):
        packet7.packet7_cuda(tris, dataclasses.replace(
            bvh, pk_meta=bvh.pk_meta.long()), o, d, t_min, t_max, False)


@pytest.fixture(scope="module")
def vsl_group():
    """Kernel arguments for G = 8 records over 16,384 pixels (numpy seed 3),
    with 7 black pixels and ~80% of the gate bits set."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rs = np.random.default_rng(3)
    n, g = 16384, 8

    def unit(k):
        v = rs.normal(size=(k, 3))
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    def cuda(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device="cuda")

    pos = cuda(rs.uniform(-2, 2, (n, 3)))
    kd = rs.uniform(0, 0.6, (n, 3))
    ks = rs.uniform(0, 0.3, (n, 3))
    kd[:7] = ks[:7] = 0.0
    wi10 = mu.normalize(cuda([0.0, 0.0, 6.0])[None] - pos)
    pix = vsl_kernel.pack_pixels(pos, cuda(unit(n)), cuda(kd), cuda(ks),
                                 cuda(rs.uniform(1, 64, n)), wi10)
    recs = dict(pos=cuda(rs.uniform(-3, 3, (g, 3))), normal=cuda(unit(g)),
                flux_dir=cuda(unit(g)), flux=cuda(rs.uniform(0, 2, (g, 3))),
                kd=cuda(rs.uniform(0, 0.7, (g, 3))),
                ks=cuda(rs.uniform(0, 0.3, (g, 3))),
                ns=cuda(rs.uniform(1, 32, g)))
    r = cuda(0.4)
    gates = rs.uniform(size=(g, n)) < 0.8
    mask = (gates.astype(np.int64) << np.arange(g)[:, None]).sum(0)
    cos_half, counts = vsl_kernel.ctx_planes(pos, recs["pos"], r)
    table = vsl_kernel.pack_records(
        recs, torch.tensor(mu.INV_PI, device="cuda") / (r * r))
    return [pix, cuda(np.arange(n) + 1000, torch.int32),
            cuda(mask, torch.int32), cos_half, counts, table, 0xDEADBEEF, 17,
            3]


@pytest.mark.cuda
def test_vsl_kernel_matches_plain(vsl_group):
    before = vsl_kernel.launches
    got = vsl_kernel.vsl_sample_group(*vsl_group)
    torch.cuda.synchronize()
    assert vsl_kernel.launches == before + 1
    want = vsl_kernel.vsl_sample_group_plain(*vsl_group)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert want.max() > 0.0 and (got[:7] == 0.0).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_vsl_wrapper_rejects_bad_inputs(vsl_group):
    def call(i, x):
        args = list(vsl_group)
        args[i] = x
        return vsl_kernel.vsl_sample_group_cuda(*args)

    pix, pids, mask, cos_half, counts, table = vsl_group[:6]
    with pytest.raises(TypeError):
        call(4, counts.to(torch.int64))
    with pytest.raises(ValueError, match="shape"):
        call(3, cos_half[:, 1:].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        call(0, pix.T.contiguous().T)
    with pytest.raises(ValueError, match="expected"):
        call(1, pids.cpu())
    with pytest.raises(ValueError, match="records"):
        call(5, table.repeat(5, 1))
