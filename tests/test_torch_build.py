"""The CUDA build's cache key and the smoke's ptxas report, on the CPU.

``_build.library_path`` names each library by the hash of its source, of
every header beside it and of the flags: an edited header must rebuild
every library (they include it by name), an unchanged tree must load
what it built.  Nothing here needs ``nvcc``; the sources are copied
under ``tmp_path`` and ``_build._CSRC`` points there.
"""

import shutil

import pytest

from distkeras_tpu_torch.ops import _build

SOURCES = sorted(p.stem for p in _build._CSRC.glob("*.cu"))
HEADERS = sorted(p.name for p in _build._CSRC.glob("*.cuh"))


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    tree = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, tree)
    monkeypatch.setattr(_build, "_CSRC", tree)
    return tree


def test_the_tree_has_the_shared_backward_header():
    assert "flash_bwd_mma.cuh" in HEADERS
    for name in ("flash_attention_bwd", "flash_hop"):
        text = (_build._CSRC / f"{name}.cu").read_text()
        assert '#include "flash_bwd_mma.cuh"' in text


@pytest.mark.parametrize("name", ["flash_attention_fwd", "flash_hop"])
def test_both_forwards_include_the_shared_forward_header(name):
    assert "flash_fwd_mma.cuh" in HEADERS
    text = (_build._CSRC / f"{name}.cu").read_text()
    assert '#include "flash_fwd_mma.cuh"' in text


def test_the_fused_block_includes_the_tensor_core_product_header():
    assert "fused_gemm.cuh" in HEADERS
    text = (_build._CSRC / "fused_block.cu").read_text()
    assert '#include "fused_gemm.cuh"' in text


@pytest.mark.parametrize("name", SOURCES)
def test_an_unchanged_tree_gives_the_same_path(csrc, tmp_path, monkeypatch,
                                               name):
    first = _build.library_path(name)
    assert _build.library_path(name) == first
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"
    assert first.name.startswith(f"{name}-")
    # the key is the content, not where the tree lies
    moved = tmp_path / "moved"
    shutil.copytree(csrc, moved)
    monkeypatch.setattr(_build, "_CSRC", moved)
    assert _build.library_path(name) == first


@pytest.mark.parametrize("header", HEADERS)
@pytest.mark.parametrize("name", SOURCES)
def test_editing_a_header_changes_the_path(csrc, name, header):
    before = _build.library_path(name)
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build.library_path(name) != before


@pytest.mark.parametrize("name", SOURCES)
def test_editing_the_source_or_adding_a_header_changes_the_path(csrc,
                                                                 name):
    before = _build.library_path(name)
    (csrc / "added.cuh").write_text("#pragma once\n")
    with_header = _build.library_path(name)
    assert with_header != before
    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path(name) not in (before, with_header)


def test_editing_another_source_keeps_the_path(csrc):
    a, b = SOURCES[0], SOURCES[1]
    before = _build.library_path(a)
    src = csrc / f"{b}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path(a) == before


# excerpts of nvcc -Xptxas -v for the flash sources, in the compiler's
# own format (the forward kernels' as sm_90a reported them)
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__a2c582f9_22_flash_attention_bwd_cu_107c2caf10dkv_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_iifi' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__a2c582f9_22_flash_attention_bwd_cu_107c2caf10dkv_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_iifi
    0 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__a2c582f9_22_flash_attention_bwd_cu_107c2caf9dq_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_PKfS6_PS2_iifi' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__a2c582f9_22_flash_attention_bwd_cu_107c2caf9dq_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_PKfS6_PS2_iifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__a2c582f9_22_flash_attention_bwd_cu_107c2caf9dq_kernelIfLi128EEEvPKT_S3_S3_S3_PKfS5_PS1_iifi' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__a2c582f9_22_flash_attention_bwd_cu_107c2caf9dq_kernelIfLi128EEEvPKT_S3_S3_S3_PKfS5_PS1_iifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN9flash_hop13hop_dq_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_PKfS6_Pfiiiiifii' for 'sm_90a'
ptxas info    : Function properties for _ZN9flash_hop13hop_dq_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_PKfS6_Pfiiiiifii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 112 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3954c0ef_22_flash_attention_fwd_cu_2c13897910fwd_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_PS2_Pfiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__3954c0ef_22_flash_attention_fwd_cu_2c13897910fwd_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_PS2_Pfiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 238 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3954c0ef_22_flash_attention_fwd_cu_2c13897910fwd_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_PS2_Pfiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__3954c0ef_22_flash_attention_fwd_cu_2c13897910fwd_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_PS2_Pfiifi
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3954c0ef_22_flash_attention_fwd_cu_2c13897910fwd_kernelIfLi128EEEvPKT_S3_S3_PS1_Pfiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__3954c0ef_22_flash_attention_fwd_cu_2c13897910fwd_kernelIfLi128EEEvPKT_S3_S3_PS1_Pfiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3954c0ef_22_flash_attention_fwd_cu_2c13897910fwd_kernelIfLi64EEEvPKT_S3_S3_PS1_Pfiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__3954c0ef_22_flash_attention_fwd_cu_2c13897910fwd_kernelIfLi64EEEvPKT_S3_S3_PS1_Pfiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN9flash_hop14hop_fwd_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_PfS5_S5_iiiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN9flash_hop14hop_fwd_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_PfS5_S5_iiiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 226 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN9flash_hop14hop_fwd_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_PfS5_S5_iiiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN9flash_hop14hop_fwd_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_PfS5_S5_iiiiifi
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN9flash_hop14hop_fwd_kernelIfLi128EEEvPKT_S3_S3_PfS4_S4_iiiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN9flash_hop14hop_fwd_kernelIfLi128EEEvPKT_S3_S3_PfS4_S4_iiiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 89 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN9flash_hop14hop_fwd_kernelIfLi64EEEvPKT_S3_S3_PfS4_S4_iiiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN9flash_hop14hop_fwd_kernelIfLi64EEEvPKT_S3_S3_PfS4_S4_iiiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 76 registers, used 1 barriers
"""


@pytest.mark.parametrize("kernel,want", [
    ("dkv_kernel", {"bf16_d128": {"registers": 255, "spill_stores": 24,
                                  "spill_loads": 16}}),
    ("dq_kernel", {"bf16_d64": {"registers": 96, "spill_stores": 0,
                                "spill_loads": 0},
                   "f32_d128": {"registers": 128, "spill_stores": 0,
                                "spill_loads": 0}}),
    ("hop_dq_kernel", {"bf16_d64": {"registers": 112, "spill_stores": 0,
                                    "spill_loads": 0}}),
    ("hop_dkv_kernel", {}),
    # the length prefix keeps fwd_kernel from matching hop_fwd_kernel
    ("fwd_kernel", {"bf16_d128": {"registers": 238, "spill_stores": 0,
                                  "spill_loads": 0},
                    "bf16_d64": {"registers": 128, "spill_stores": 8,
                                 "spill_loads": 8},
                    "f32_d128": {"registers": 80, "spill_stores": 0,
                                 "spill_loads": 0},
                    "f32_d64": {"registers": 64, "spill_stores": 0,
                                "spill_loads": 0}}),
    ("hop_fwd_kernel", {"bf16_d128": {"registers": 226, "spill_stores": 0,
                                      "spill_loads": 0},
                        "bf16_d64": {"registers": 128, "spill_stores": 4,
                                     "spill_loads": 4},
                        "f32_d128": {"registers": 89, "spill_stores": 0,
                                     "spill_loads": 0},
                        "f32_d64": {"registers": 76, "spill_stores": 0,
                                    "spill_loads": 0}}),
])
def test_smoke_reads_registers_and_spills_per_instantiation(kernel, want):
    import chip_smoke

    assert chip_smoke._kernel_resources(PTXAS_LOG, kernel) == want


# an excerpt of nvcc -Xptxas -v for fused_block.cu (sm_90a): the bf16
# backwards' product body, fused_block::tc::gemm_kernel<BN, NWG, A_MN,
# B_MN, Epi>, at four of its instantiations
FUSED_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN11fused_block2tc11gemm_kernelILi128ELi2ELb0ELb0ENS0_5DhEpiEEEv14CUtensorMap_stS3_S3_S3_S3_NS0_4GeomET3_' for 'sm_90a'
ptxas info    : Function properties for _ZN11fused_block2tc11gemm_kernelILi128ELi2ELb0ELb0ENS0_5DhEpiEEEv14CUtensorMap_stS3_S3_S3_S3_NS0_4GeomET3_
    64 bytes stack frame, 60 bytes spill stores, 60 bytes spill loads
ptxas info    : Used 96 registers, used 4 barriers, 64 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN11fused_block2tc11gemm_kernelILi64ELi2ELb0ELb0ENS0_8StoreEpiEEEv14CUtensorMap_stS3_S3_S3_S3_NS0_4GeomET3_' for 'sm_90a'
ptxas info    : Function properties for _ZN11fused_block2tc11gemm_kernelILi64ELi2ELb0ELb0ENS0_8StoreEpiEEEv14CUtensorMap_stS3_S3_S3_S3_NS0_4GeomET3_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 58 registers, used 4 barriers
ptxas info    : Compiling entry function '_ZN11fused_block2tc11gemm_kernelILi128ELi1ELb0ELb1ENS0_11BwdStatsEpiEEEv14CUtensorMap_stS3_S3_S3_S3_NS0_4GeomET3_' for 'sm_90a'
ptxas info    : Function properties for _ZN11fused_block2tc11gemm_kernelILi128ELi1ELb0ELb1ENS0_11BwdStatsEpiEEEv14CUtensorMap_stS3_S3_S3_S3_NS0_4GeomET3_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 108 registers, used 2 barriers
ptxas info    : Compiling entry function '_ZN11fused_block2tc11gemm_kernelILi128ELi1ELb1ELb1ENS0_8ChunkEpiEEEv14CUtensorMap_stS3_S3_S3_S3_NS0_4GeomET3_' for 'sm_90a'
ptxas info    : Function properties for _ZN11fused_block2tc11gemm_kernelILi128ELi1ELb1ELb1ENS0_8ChunkEpiEEEv14CUtensorMap_stS3_S3_S3_S3_NS0_4GeomET3_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 3 barriers
"""


def test_smoke_reads_the_fused_product_body_per_instantiation():
    import chip_smoke

    def info(registers, spill):
        return {"registers": registers, "spill_stores": spill,
                "spill_loads": spill}

    assert chip_smoke._kernel_resources(FUSED_PTXAS_LOG, "gemm_kernel") == {
        "BwdStatsEpi_n128_w1": info(108, 0),
        "ChunkEpi_n128_w1": info(90, 0),
        "DhEpi_n128_w2": info(96, 60),
        "StoreEpi_n64_w2": info(58, 0)}
    # the flash patterns find nothing here, nor the body's in theirs
    assert chip_smoke._kernel_resources(FUSED_PTXAS_LOG, "fwd_kernel") == {}
    assert chip_smoke._kernel_resources(PTXAS_LOG, "gemm_kernel") == {}


def test_smoke_ranges_what_each_fused_grid_was_launched_with():
    import chip_smoke

    timing = {("tail", 1): {"bwd_grids": {
                  "StatsEpi_n128_w2": {"ms": 0.1, "smem": 99328,
                                       "registers": 90},
                  "fold_kernel": {"ms": 0.01}}},
              ("tail", 2): {"bwd_grids": {
                  "StatsEpi_n128_w2": {"ms": 0.2, "smem": 132096,
                                       "registers": 90}}}}
    assert chip_smoke._launched(timing, "tail", {1: 4, 2: 1}) == {
        "StatsEpi_n128_w2": {"smem": [99328, 132096], "registers": [90, 90]}}


def test_smoke_weighs_both_conv_plans_by_launches():
    import chip_smoke

    timing = {("conv", "a"): {"bwd_plan": "store", "bwd_ms": 1.0,
                              "bwd_other_plan_ms": 2.0},
              ("conv", "b"): {"bwd_plan": "store", "bwd_ms": 4.0,
                              "bwd_other_plan_ms": 2.0},
              ("conv", "c"): {"bwd_plan": "recompute", "bwd_ms": 0.5,
                              "bwd_other_plan_ms": 0.75}}
    assert chip_smoke._plan_means(timing, {"a": 3, "b": 1, "c": 2}) == {
        "store": {"calls": 4, "chosen_ms": 1.75, "other_ms": 2.0},
        "recompute": {"calls": 2, "chosen_ms": 0.5, "other_ms": 0.75}}
