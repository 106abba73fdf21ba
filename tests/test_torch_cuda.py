"""The traversal kernel on the card against its plain PyTorch version, on
the box_field config's scene (24,010 triangles).  These tests need a CUDA
card and skip elsewhere; the file imports no JAX, so it runs on a machine
without it:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerance: closest hits agree prim for prim or tie in t at rtol 1e-4, with t
at rtol 1e-5 (the kernel is built with -fmad=false and rounds as the plain
ops do); any-hit results are equal on live lanes."""
import os

import numpy as np
import pytest
import torch

from evplp_tpu_torch.scene.config import load_config
from evplp_tpu_torch.trace import traverse

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


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_matches_plain(scene, any_hit):
    args = _rays(scene, any_hit)
    before = traverse.launches
    t_k, p_k, _, _ = traverse.traverse(*args)
    torch.cuda.synchronize()
    assert traverse.launches == before + 1
    t_p, p_p, _, _ = traverse.traverse_plain(*args)
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
def test_wrapper_rejects_bad_inputs(scene):
    tris, bvh, o, d, t_min, t_max, _ = _rays(scene, False)
    with pytest.raises(TypeError):
        traverse.traverse_cuda(tris, bvh, o.double(), d, t_min, t_max, False)
    with pytest.raises(ValueError, match="contiguous"):
        traverse.traverse_cuda(tris, bvh, o.t().contiguous().t(), d, t_min,
                               t_max, False)
    with pytest.raises(ValueError, match="shape"):
        traverse.traverse_cuda(tris, bvh, o, d, t_min[:-1], t_max, False)
