"""The CUDA kernels' sources and build recipe, checked without compiling:
every source the loader names exists, the flags target sm_90a without
fast-math, and the C symbols the wrappers bind are exported by the sources.
(The kernels themselves are built, launched and held against their plain
versions on the card by ``chip_smoke.py``.)"""

import pathlib
import re
import types

import pytest

from repro_torch.kernels import build

PKG = pathlib.Path(build.__file__).resolve().parent


def test_every_named_source_exists():
    assert set(build.SOURCES) == {"quant_matmul", "flash_attention_quant",
                                  "abfp_qdq", "flash_attention"}
    for name, fname in build.SOURCES.items():
        path = build.CSRC_DIR / fname
        assert path.is_file(), path
        assert path.suffix == ".cu"
    on_disk = {p.name for p in build.CSRC_DIR.glob("*.cu")}
    assert on_disk == set(build.SOURCES.values())


def test_flags_target_hopper_without_fast_math():
    flags = " ".join(build.NVCC_FLAGS)
    assert "sm_90a" in flags and "compute_90a" in flags
    assert "use_fast_math" not in flags and "fast-math" not in flags
    for want in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert want in flags


@pytest.mark.parametrize("name", sorted(build.SOURCES))
def test_bound_symbols_are_exported(name):
    wrapper = (PKG / f"{name}.py").read_text()
    bound = set(re.findall(r"lib\.(repro_\w+)", wrapper))
    assert bound, f"{name}.py binds no C symbol"
    source = (build.CSRC_DIR / build.SOURCES[name]).read_text()
    exported = set(re.findall(r'extern\s+"C"\s+int\s+(\w+)\s*\(', source))
    assert bound <= exported, (bound, exported)
    assert "cudaGetLastError" in source
    assert "use_fast_math" not in source


@pytest.mark.parametrize("name", sorted(build.SOURCES))
def test_sources_call_no_library_kernel(name):
    source = (build.CSRC_DIR / build.SOURCES[name]).read_text()
    for lib in ("cublas", "cudnn", "cutlass", "torch/", "ATen"):
        assert lib not in source, lib
    wrapper = (PKG / f"{name}.py").read_text()
    assert "torch.compile" not in wrapper
    assert "scaled_dot_product_attention" not in wrapper
    assert "_int_mm" not in wrapper


def test_library_path_is_under_the_build_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    path = build.library_path("quant_matmul")
    assert path.parent == tmp_path
    assert re.fullmatch(r"libquant_matmul-[0-9a-f]{12}\.so", path.name)
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR")
    default = build.library_path("quant_matmul")
    assert default.parent.parts[-2:] == ("build", "repro_torch_kernels")
    assert default.name == path.name  # keyed by source + flags only


def test_wrappers_carry_launch_counters():
    from repro_torch.kernels.abfp_qdq import abfp_qdq
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_quant import \
        flash_attention_quant
    from repro_torch.kernels.quant_matmul import (abfp_matmul,
                                                  abfp_matmul_int8,
                                                  quant_matmul)

    for fn in (quant_matmul, flash_attention_quant, abfp_matmul,
               abfp_matmul_int8, abfp_qdq, flash_attention):
        assert isinstance(fn.launches, int)


@pytest.mark.parametrize("name", sorted(build.SOURCES))
def test_headers_are_hashed_and_include_no_pytorch(name):
    """Every source and header it includes: no PyTorch header (the
    libraries have a plain C interface), and each local header is part of
    the library's key."""
    src = build.CSRC_DIR / build.SOURCES[name]
    for path in [src, *build.local_headers(src)]:
        text = path.read_text()
        for hdr in re.findall(r"#\s*include\s*[<\"]([^>\"]+)[>\"]", text):
            assert not hdr.startswith(("torch", "ATen", "c10", "cutlass",
                                       "cublas", "cudnn")), (path, hdr)
    # quant_matmul and abfp_qdq share the group QDQ; quant_matmul and both
    # attention sources the PTX wrappers (cp.async, ldmatrix, mma.sync)
    shared = {"quant_matmul": ["abfp_qdq.cuh", "ptx.cuh"],
              "abfp_qdq": ["abfp_qdq.cuh"],
              "flash_attention_quant": ["ptx.cuh"],
              "flash_attention": ["ptx.cuh"]}
    assert [h.name for h in build.local_headers(src)] == shared[name]


def test_header_edit_changes_every_library_key(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "shared.cuh").write_text("#pragma once\n#include \"deep.cuh\"\n")
    (csrc / "deep.cuh").write_text("// v1\n")
    (csrc / "a.cu").write_text('#include "shared.cuh"\nint a;\n')
    (csrc / "b.cu").write_text('#include <cuda_runtime.h>\nint b;\n')
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "SOURCES", {"a": "a.cu", "b": "b.cu"})
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    assert [h.name for h in build.local_headers(csrc / "a.cu")] == [
        "shared.cuh", "deep.cuh"]
    before = {n: build.library_path(n) for n in ("a", "b")}
    (csrc / "deep.cuh").write_text("// v2\n")  # a header two levels down
    after = {n: build.library_path(n) for n in ("a", "b")}
    assert after["a"] != before["a"]
    assert after["b"] == before["b"]  # includes no local header


def test_flags_are_the_hopper_build_for_every_source():
    """One nvcc per source with the same flags: sm_90a code, C++17, -O3,
    a shared library with position-independent code."""
    flags = list(build.NVCC_FLAGS)
    i = flags.index("-gencode")
    assert flags[i + 1] == "arch=compute_90a,code=sm_90a"
    assert "--use_fast_math" not in flags and "-ftz=true" not in flags


def test_attention_kernels_are_defined_and_dispatched():
    """Every kernel ``plan_attention`` can name (attention_long_kernel
    among them) is a ``__global__`` of flash_attention_quant.cu that the C
    entry dispatches by its id and the wrapper counts; the long kernel's
    ring uses the planner's constants, and its cluster, shared memory and
    score slots come from the plan (no second copy of those rules in the
    source); the C entry takes the arguments the wrapper binds."""
    from repro_torch.kernels import flash_attention_quant as faq

    source = (build.CSRC_DIR /
              build.SOURCES["flash_attention_quant"]).read_text()
    assert set(faq._KERNEL_IDS) == set(
        faq.flash_attention_quant.launches_by_kernel)
    assert "attention_long_kernel" in faq._KERNEL_IDS
    for name, kid in faq._KERNEL_IDS.items():
        assert re.search(r"__global__ void __launch_bounds__\([^)]*\)\s*"
                         rf"{name}\(const Params p\)", source), name
        if kid:
            assert f"if (kernel == {kid})" in source, name
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", source))
    assert int(consts["kLClusterMax"]) == faq.LONG_CLUSTER
    assert int(consts["kPKeys"]) == faq.PREFILL_KEYS
    assert int(consts["kPRows"]) == faq.PREFILL_ROWS
    # a cluster launch (cudaLaunchKernelEx) for each cluster kernel
    assert source.count("cudaLaunchKernelEx(&cfg, attention_long_kernel") \
        == 1
    for rule in ("long_cluster", "long_slots", "long_smem_bytes"):
        assert not re.search(rf"\b{rule}\(", source), rule
    assert "const int C = p.cluster;" in source
    assert "const size_t bytes = p.smem;" in source
    entry = re.search(r'extern "C" int repro_flash_attention_quant\(([^)]*)\)',
                      source).group(1)
    lib = types.SimpleNamespace(repro_flash_attention_quant=(
        types.SimpleNamespace(argtypes=None, restype=None)))
    assert len(faq._bind(lib).argtypes) == entry.count(",") + 1
