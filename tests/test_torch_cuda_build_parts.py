"""Building a CUDA source in parts (``utils/cuda_build.py``, ``csrc/parts.cuh``), on the CPU.

No compiler runs here: the commands of a parted source, the library's name, the
failure of one part, and ``kernel_table`` over ``ptxas`` reports of a file built
whole and in parts (the same kernels under the per-unit names nvcc gives an
anonymous namespace). Seconds on one worker.
"""

import os

import pytest

from self_attention_tacotron_torch.utils import cuda_build

REPORT = """ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    464 bytes stack frame, 368 bytes spill stores, 680 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 448 bytes cmem[0]
"""
KERNEL = "19fused_decode_kernelILb0ELb0ELb0ELb0ELb0EfEEvNS_4PtrsIT4_EENS_4DimsENS_7ScalarsENS_4HeldE"


def test_each_part_compiles_its_share_and_the_whole_file_builds_at_once(monkeypatch):
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")
    parts = cuda_build._commands("x/fused_decode.cu", "lib.so", 4)
    assert [c[c.index("-o") + 1] for c in parts] == [f"lib.so.part{i}.o" for i in range(4)]
    for i, cmd in enumerate(parts):
        assert "-c" in cmd and "-shared" not in cmd
        assert "-DSATT_PARTS=4" in cmd and f"-DSATT_PART={i}" in cmd
    (whole,) = cuda_build._commands("x/bigru.cu", "lib.so", 1)
    assert "-shared" in whole and not any(f.startswith("-DSATT_PART") for f in whole)
    assert cuda_build.parts_of("fused_decode") == cuda_build.parts_of("fused_teacher") == 4
    assert cuda_build.parts_of("bigru") == 1


def test_the_library_name_follows_the_parts(monkeypatch):
    before = cuda_build.library_path("fused_teacher")
    monkeypatch.setitem(cuda_build.KERNEL_PARTS, "fused_teacher", 2)
    assert cuda_build.library_path("fused_teacher") != before


def test_a_failing_part_fails_the_build_and_leaves_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "false")
    out = str(tmp_path / "libfused_decode-x.so")
    procs, tmp = cuda_build._start_build("fused_decode", out)
    assert len(procs) == 4
    with pytest.raises(RuntimeError, match="nvcc failed on fused_decode.cu"):
        cuda_build._finish_build("fused_decode", procs, tmp, out)
    assert os.listdir(tmp_path) == []


def test_kernel_table_names_kernels_without_their_unit():
    whole = REPORT.format(name=f"_ZN48_GLOBAL__N__a0a05f11_15_fused_decode_cu_985bebbd{KERNEL}")
    part = REPORT.format(name=f"_ZN54_GLOBAL__N__120918_0000000_15_fused_decode_cu_1a2b3c4d{KERNEL}")
    table = cuda_build.kernel_table(whole)
    assert table == {f"_ZN{KERNEL}": (128, 464, 368, 680)}
    assert cuda_build.kernel_table(part) == table
