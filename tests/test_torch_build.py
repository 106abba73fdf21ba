"""The port's native build cache: a library is rebuilt when a header its
source includes changes, and every traversal kernel's source is hashed
with the shared ray-test header (csrc/ray_common.cuh)."""
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
