"""The VSL sample loop over a group of records: the Hopper kernel's wrapper
and its plain version.

`vsl_sample_group` runs, for G <= MAX_GROUP records and N pixels, the
adaptive 3-strategy MIS sample loop of every gated (record, pixel) pair and
returns the sum over the group of each pair's estimate divided by its
sample count, (N, 3) float32.  It is the counterpart of the JAX package's
Pallas kernel (`integrators/vsl_kernel.py:_kernel`, entry
`vsl_sample_group`), without its TPU layout (128-lane planes, byte-packed
counts, row blocks).

Inputs:
  pix        (16, N) f32   pixel planes: pos xyz, normal xyz, kd rgb,
                           ks rgb, ns, wi10 xyz
  pixel_ids  (N,) int32    global pixel ids (the draws' counters)
  gates      (N,) int32    bit g set = record g is gated in (pre & ~occluded)
  cos_half   (G, N) f32    cosine of the cone's half angle
  counts     (G, N) int32  adaptive sample counts
  table      (G, 24) f32   `pack_records`
  seed0, seed1, rec_base   uint32 seeds and the group's first record id

`cos_half` and `counts` come from `ctx_planes`, in PyTorch, outside the
kernel, so that the kernel and the plain version read the very same counts.

On a CUDA tensor the wrapper launches `csrc/vsl_sample.cu` (built with nvcc
at first use, bound with ctypes) and never anything else; on a CPU tensor it
runs `vsl_sample_group_plain`, which also serves as the kernel's reference on
the card.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from evplp_tpu_torch.core import brdf
from evplp_tpu_torch.core import mathutil as mu
from evplp_tpu_torch.native.build import check_tensor, load_cuda_library

MAX_VSL_SAMPLES = 101    # half cone <= pi/2 -> numSamples <= 101
MAX_GROUP = 32           # records per call: one bit each in the gate mask
NPLANE = 16
NREC_F = 24

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "vsl_sample.cu")

launches = 0


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    # pix, pixel_ids, gates, cos_half, counts, table, G, N, seed0, seed1,
    # rec_base, out, stream
    return load_cuda_library("vsl_sample", _SRC, {
        "evplp_vsl_sample_group": [vp] * 6 + [ci, ci, cu, cu, ci, vp, vp]})


def pack_pixels(position, normal, kd, ks, ns, wi10) -> torch.Tensor:
    """(N, 3) / (N,) pixel arrays -> (16, N) contiguous planes."""
    return torch.cat([position.T, normal.T, kd.T, ks.T, ns[None],
                      wi10.T]).to(torch.float32).contiguous()


def pack_records(recs: dict, vsl_inv_pi_r2) -> torch.Tensor:
    """Record fields (G, ...) -> (G, 24) table: pos3, normal3, flux_dir3,
    flux3 * invPiR2, kd3, ks3, ns, black2, reflect(-flux_dir, normal)3,
    p_select_lambert."""
    refl = mu.reflect(-recs["flux_dir"], recs["normal"])
    black2 = brdf.is_black(recs["kd"], recs["ks"]).to(torch.float32)
    p_l2 = brdf.p_select_lambert(recs["kd"], recs["ks"])
    return torch.cat([
        recs["pos"], recs["normal"], recs["flux_dir"],
        recs["flux"] * vsl_inv_pi_r2, recs["kd"], recs["ks"],
        recs["ns"][:, None], black2[:, None], refl, p_l2[:, None],
    ], dim=1).to(torch.float32).contiguous()


def ctx_planes(position, rec_pos, radius):
    """cos_half (G, N) f32 and the adaptive counts (G, N) int32 of G record
    positions against N pixel positions, for a VSL of radius `radius`:
    numSamples = int(halfCone * 200/pi) + 1 (lighttracing.cu:621-632)."""
    v12 = rec_pos[:, None, :] - position[None]
    d2 = torch.clamp_min(mu.dot(v12, v12), 1e-20)
    rdratio = radius / torch.sqrt(d2)
    half_cone = torch.where(rdratio >= 1.0, math.pi / 2.0,
                            torch.asin(torch.clamp_max(rdratio, 1.0)))
    num = (half_cone * (200.0 / math.pi)).to(torch.int32) + 1
    return torch.cos(half_cone).contiguous(), num.contiguous()


def _check_inputs(pix, pixel_ids, gates, cos_half, counts, table):
    """Raise on a device, dtype, shape or layout the kernel does not take."""
    dev = pix.device
    n, g = pix.shape[1], table.shape[0]
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"a group holds 1 to {MAX_GROUP} records, got {g}")
    f32, i32 = torch.float32, torch.int32
    for x, name, dt, shape in (
            (pix, "pix", f32, (NPLANE, n)), (pixel_ids, "pixel_ids", i32, (n,)),
            (gates, "gates", i32, (n,)), (cos_half, "cos_half", f32, (g, n)),
            (counts, "counts", i32, (g, n)), (table, "table", f32, (g, NREC_F))):
        check_tensor(x, name, dt, shape, dev)


def vsl_sample_group_cuda(pix, pixel_ids, gates, cos_half, counts, table,
                          seed0: int, seed1: int, rec_base: int) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream; returns (N, 3)."""
    global launches
    dev = pix.device
    if dev.type != "cuda":
        raise ValueError(f"the VSL sample kernel needs CUDA tensors, got {dev}")
    _check_inputs(pix, pixel_ids, gates, cos_half, counts, table)
    n, g = pix.shape[1], table.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.evplp_vsl_sample_group(
            pix.data_ptr(), pixel_ids.data_ptr(), gates.data_ptr(),
            cos_half.data_ptr(), counts.data_ptr(), table.data_ptr(), g, n,
            seed0 & 0xFFFFFFFF, seed1 & 0xFFFFFFFF, rec_base, out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"VSL sample kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def vsl_sample_group_plain(pix, pixel_ids, gates, cos_half, counts, table,
                           seed0: int, seed1: int, rec_base: int,
                           observe=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the group's G records as a
    leading dimension, sampled to the group's largest gated count with
    every pixel masked by its own count (vsl._sample_loop).  observe, if
    given, sees each sample's (G, N) masks (vsl._sample_step)."""
    # imported here: vsl imports this module
    from evplp_tpu_torch.integrators import vsl

    _check_inputs(pix, pixel_ids, gates, cos_half, counts, table)
    g = table.shape[0]
    px = dict(pos=pix[0:3].T, n=pix[3:6].T, kd=pix[6:9].T, ks=pix[9:12].T,
              ns=pix[12])
    t = table[:, None, :]
    rec = dict(pos=t[..., 0:3], normal=t[..., 3:6], flux_dir=t[..., 6:9],
               kd=t[..., 12:15], ks=t[..., 15:18], ns=t[..., 18])
    ids = torch.arange(g, dtype=torch.int32, device=pix.device)[:, None]
    gate = ((gates[None, :] >> ids) & 1) > 0
    ctx = vsl._record_ctx(px, rec["pos"], cos_half, counts, gate, pix[13:16].T)
    rng_ctx = (seed0, seed1, pixel_ids, rec_base + ids.to(torch.int64))
    out = vsl._sample_loop(rec, ctx, rng_ctx, t[..., 9:12], t[..., 19] > 0.5,
                           observe)
    total = torch.zeros_like(out[0])
    for k in range(g):        # the kernel's order: record 0 first
        total = total + out[k]
    return total


def vsl_sample_group(pix, pixel_ids, gates, cos_half, counts, table,
                     seed0: int, seed1: int, rec_base: int) -> torch.Tensor:
    """The group's summed estimates (N, 3): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    args = (pix, pixel_ids, gates, cos_half, counts, table, seed0, seed1,
            rec_base)
    if pix.device.type == "cuda":
        return vsl_sample_group_cuda(*args)
    if pix.device.type == "cpu":
        return vsl_sample_group_plain(*args)
    raise ValueError(f"no VSL sample loop for device {pix.device}")
