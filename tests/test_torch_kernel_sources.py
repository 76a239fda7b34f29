"""The CUDA kernels' sources and build recipe, checked without compiling:
every source the loader names exists, the flags target sm_90a without
fast-math, and the C symbols the wrappers bind are exported by the sources.
(The kernels themselves are built, launched and held against their plain
versions on the card by ``chip_smoke.py``.)"""

import pathlib
import re

import pytest

from repro_torch.kernels import build

PKG = pathlib.Path(build.__file__).resolve().parent


def test_every_named_source_exists():
    assert set(build.SOURCES) == {"quant_matmul", "flash_attention_quant"}
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
    from repro_torch.kernels.flash_attention_quant import \
        flash_attention_quant
    from repro_torch.kernels.quant_matmul import quant_matmul

    assert isinstance(quant_matmul.launches, int)
    assert isinstance(flash_attention_quant.launches, int)
