"""The port's native build cache: a library is rebuilt when a header its
source includes changes, every traversal kernel's source is hashed with the
shared ray-test header (csrc/ray_common.cuh), and the compiler's output is
kept beside each library, where ptxas's report of each kernel's registers,
spills and shared memory is read."""
import ctypes
import os

from evplp_tpu_torch.native import build
from evplp_tpu_torch.trace import packet, packet7, traverse


def test_header_edit_rebuilds(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    src, hdr = tmp_path / "k.c", tmp_path / "k.h"
    hdr.write_text("#define K 1\n")
    src.write_text('#include "k.h"\nint k(void) { return K; }\n')
    cmd = ["gcc", "-shared", "-fPIC"]
    first = build.build_library("k", [str(src)], cmd, [str(hdr)])
    assert build.build_library("k", [str(src)], cmd, [str(hdr)]) == first
    hdr.write_text("#define K 2\n")
    second = build.build_library("k", [str(src)], cmd, [str(hdr)])
    assert second != first
    assert ctypes.CDLL(first).k() == 1
    assert ctypes.CDLL(second).k() == 2


def test_traversal_sources_hash_the_shared_header():
    for mod in (traverse, packet7, packet):
        headers = build.headers_beside(mod._SRC)
        assert [os.path.basename(h) for h in headers] == ["ray_common.cuh"]
        with open(mod._SRC) as f:
            assert '#include "ray_common.cuh"' in f.read()


def test_build_keeps_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "w.c"
    src.write_text('#warning "kept in the log"\nint w(void) { return 3; }\n')
    path = build.build_library("w", [str(src)], ["gcc", "-shared", "-fPIC"])
    with open(f"{path}.log") as f:
        assert "kept in the log" in f.read()
    assert ctypes.CDLL(path).w() == 3


def test_ptxas_report_reads_each_kernel():
    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117vsl_sample_kernelEPKfPKiS3_S1_S3_S1_iijjiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117vsl_sample_kernelEPKfPKiS3_S1_S3_S1_iijjiPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 1024 bytes smem, 420 bytes cmem[0]
ptxas info    : Compiling entry function 'plain_c_kernel' for 'sm_90a'
ptxas info    : Function properties for plain_c_kernel
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 380 bytes cmem[0]
"""
    assert build.ptxas_report(text) == {
        "vsl_sample_kernel": dict(registers=96, spill_stores=4,
                                  spill_loads=12, stack=8, smem=1024),
        "plain_c_kernel": dict(registers=40, spill_stores=0, spill_loads=0,
                               stack=0, smem=0)}
    assert "-Xptxas" in build.NVCC_FLAGS and "-fmad=false" in build.NVCC_FLAGS
