"""The CUDA build's cache key and the smoke's ptxas report, on the CPU.

``_build.library_path`` names each library by the hash of its source, of
every header beside it and of the flags: an edited header must rebuild
every library (they include it by name), an unchanged tree must load
what it built.  Nothing here needs ``nvcc``; the sources are copied
under ``tmp_path`` and ``_build._CSRC`` points there.
"""

import re
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


# the one-element norm passes, their per-block folds and the mma.sync
# product: the forwards and the f32 kernels now run the 16-byte passes
# and (bf16) the wgmma body
@pytest.mark.parametrize("name", ["stats_kernel", "apply_kernel",
                                  "bwd_stats_kernel", "bwd_apply_kernel",
                                  "gemm_mma_kernel", "mma_bf16", "norm_bwd",
                                  "norm_smem", "fold_lanes"])
def test_the_fused_block_no_longer_defines_the_old_passes(name):
    text = (_build._CSRC / "fused_block.cu").read_text()
    assert not re.search(rf"\b{name}\b", text)


def _function_body(text, name):
    """The text of C++ function ``name``'s definition, to its closing
    brace at the start of a line."""
    start = re.search(rf"^int {name}\(", text, re.M).start()
    return text[start:text.index("\n}\n", start)]


@pytest.mark.parametrize("name", ["conv_gn_fwd_tc", "tail_fwd_tc"])
def test_the_bf16_forwards_run_the_tensor_core_product(name):
    """#7's and #9's bf16 arms: P1 with the statistics epilogue, P2 with
    the apply epilogue, both through tc::rows_times_w; the f32 arms keep
    the FMA product."""
    text = (_build._CSRC / "fused_block.cu").read_text()
    body = _function_body(text, name)
    assert body.count("tc::rows_times_w(") == 2
    assert "tc::StatsEpi{" in body and "tc::ApplyEpi{" in body
    entry = _function_body(text.replace('extern "C" int', "int"),
                           name.replace("_tc", ""))
    assert f"return {name}(" in entry
    assert "gemm(" in _function_body(text, name.replace("_tc", "_f32"))
    assert "struct ApplyEpi" in (_build._CSRC / "fused_gemm.cuh").read_text()


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
                  "fold_kernel": {"ms": 0.01}},
                            "fwd_grids": {
                  "ApplyEpi_n128_w2": {"ms": 0.1, "smem": 113736,
                                       "registers": 88},
                  "apply8_kernel": {"ms": 0.02, "smem": 0,
                                    "registers": 32}}},
              ("tail", 2): {"bwd_grids": {
                  "StatsEpi_n128_w2": {"ms": 0.2, "smem": 132096,
                                       "registers": 90}},
                            "fwd_grids": {
                  "ApplyEpi_n128_w2": {"ms": 0.2, "smem": 81920,
                                       "registers": 88}}}}
    assert chip_smoke._launched(timing, "tail", {1: 4, 2: 1}) == {
        "StatsEpi_n128_w2": {"smem": [99328, 132096], "registers": [90, 90]}}
    # the forwards' grids, read the same way
    assert chip_smoke._launched(timing, "tail", {1: 4, 2: 1}, "fwd") == {
        "ApplyEpi_n128_w2": {"smem": [81920, 113736], "registers": [88, 88]},
        "apply8_kernel": {"smem": [0, 0], "registers": [32, 32]}}


def test_smoke_reads_a_grid_a_call_from_a_window_of_calls():
    """Ten calls of a tail forward in the trace, of which the window lost
    the first call's first grid and gained one grid of the call before:
    each grid's time a call is its mean over its launches times its
    launches a call (group_stats twice), whatever the window's edges."""
    import chip_smoke

    def ev(name, dur, **args):
        return {"cat": "kernel", "name": name, "dur": dur, "args": args}

    stats8 = "void fused_block::(anonymous namespace)::stats8_kernel<bf16>"
    groups = "fused_block::(anonymous namespace)::group_stats_kernel(...)"
    body = ("void fused_block::tc::gemm_kernel<128, 2, false, true, "
            "fused_block::tc::ApplyEpi>(...)")
    events = [ev(groups, 10.0)]                   # the call before's
    for call in range(10):
        if call:
            events.append(ev(stats8, 20.0))
        events += [ev(groups, 10.0), ev(groups, 12.0),
                   ev(body, 300.0, **{"shared memory": 113736,
                                      "registers per thread": 96})]
    got = chip_smoke._grids_of(events)
    assert got["stats8_kernel"] == {"ms": pytest.approx(0.02)}
    assert got["group_stats_kernel"] == {"ms": pytest.approx(
        (10.0 * 11 + 12.0 * 10) / 21 * 2 / 1e3)}
    assert got["ApplyEpi_n128_w2"] == {"ms": pytest.approx(0.3),
                                       "smem": 113736, "registers": 96}


def test_smoke_weighs_both_conv_plans_by_launches():
    import chip_smoke

    timing = {("conv", "a"): {"bwd_plan": "store", "bwd_ms": 1.0,
                              "bwd_other_plan_ms": 2.0,
                              "fwd_plan": "recompute", "fwd_ms": 0.5,
                              "fwd_other_plan_ms": 0.6},
              ("conv", "b"): {"bwd_plan": "store", "bwd_ms": 4.0,
                              "bwd_other_plan_ms": 2.0,
                              "fwd_plan": "store", "fwd_ms": 0.2,
                              "fwd_other_plan_ms": 0.4},
              ("conv", "c"): {"bwd_plan": "recompute", "bwd_ms": 0.5,
                              "bwd_other_plan_ms": 0.75,
                              "fwd_plan": "recompute", "fwd_ms": 0.8,
                              "fwd_other_plan_ms": 0.7},
              ("tail", "d"): {"fwd_plan": "store", "fwd_ms": 1.0,
                              "fwd_other_plan_ms": 1.5}}
    assert chip_smoke._plan_means(timing, {"a": 3, "b": 1, "c": 2}) == {
        "store": {"calls": 4, "chosen_ms": 1.75, "other_ms": 2.0},
        "recompute": {"calls": 2, "chosen_ms": 0.5, "other_ms": 0.75}}
    # the forwards' plans, by kind
    fwd = chip_smoke._plan_means(timing, {"a": 3, "b": 1, "c": 1}, "conv",
                                 "fwd")
    assert fwd["store"] == {"calls": 1, "chosen_ms": 0.2, "other_ms": 0.4}
    assert fwd["recompute"]["calls"] == 4
    assert fwd["recompute"]["chosen_ms"] == pytest.approx(0.575)
    assert fwd["recompute"]["other_ms"] == pytest.approx(0.625)
    assert chip_smoke._plan_means(timing, {"d": 16}, "tail", "fwd") == {
        "store": {"calls": 16, "chosen_ms": 1.0, "other_ms": 1.5}}


def test_smoke_checks_both_forward_plans_once_a_stage():
    """One call shape per stage (row count), the widest first, for the
    check that the two forward plans give the same bits."""
    import chip_smoke

    conv = [(256, 784, 512, 128, 32, True), (256, 3136, 256, 64, 32, True),
            (256, 49, 2048, 512, 32, True), (256, 3136, 64, 64, 32, True),
            (256, 196, 1024, 256, 32, True), (256, 784, 256, 512, 32, False)]
    assert chip_smoke._stage_keys(conv) == [
        (256, 3136, 64, 64, 32, True), (256, 784, 256, 512, 32, False),
        (256, 196, 1024, 256, 32, True), (256, 49, 2048, 512, 32, True)]


# an nvcc -Xptxas -v excerpt in the compiler's format for the forwards'
# apply epilogue, gemm_kernel<BN, NWG, false, true, ApplyEpi>
FORWARD_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN11fused_block2tc11gemm_kernelILi128ELi2ELb0ELb1ENS0_8ApplyEpiEEEv14CUtensorMap_stS3_S3_S3_S3_NS0_4GeomET3_' for 'sm_90a'
ptxas info    : Function properties for _ZN11fused_block2tc11gemm_kernelILi128ELi2ELb0ELb1ENS0_8ApplyEpiEEEv14CUtensorMap_stS3_S3_S3_S3_NS0_4GeomET3_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 92 registers, used 4 barriers
ptxas info    : Compiling entry function '_ZN11fused_block2tc11gemm_kernelILi64ELi1ELb0ELb1ENS0_8ApplyEpiEEEv14CUtensorMap_stS3_S3_S3_S3_NS0_4GeomET3_' for 'sm_90a'
ptxas info    : Function properties for _ZN11fused_block2tc11gemm_kernelILi64ELi1ELb0ELb1ENS0_8ApplyEpiEEEv14CUtensorMap_stS3_S3_S3_S3_NS0_4GeomET3_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 60 registers, used 2 barriers
"""


def test_smoke_reads_the_forward_apply_epilogue_per_instantiation():
    import chip_smoke

    zero = {"spill_stores": 0, "spill_loads": 0}
    got = chip_smoke._kernel_resources(FORWARD_PTXAS_LOG, "gemm_kernel")
    assert got == {"ApplyEpi_n128_w2": {"registers": 92, **zero},
                   "ApplyEpi_n64_w1": {"registers": 60, **zero}}
    assert "ApplyEpi" in chip_smoke.PTXAS_EPILOGUES["conv1x1_gn_fwd"]
    assert chip_smoke.PTXAS_EPILOGUES["bottleneck_tail_fwd"] == (
        "StatsEpi", "ApplyEpi")


def _gn_source():
    return (_build._CSRC / "group_norm.cu").read_text()


def _kernel_text(text, name):
    """The text of ``__global__`` kernel ``name``: from its name to the
    closing brace at the start of a line."""
    start = re.search(rf"\b{name}\(", text).start()
    return text[start:text.index("\n}\n", start)]


@pytest.mark.parametrize("name", ["fwd_cluster_kernel", "bwd_cluster_kernel"])
def test_group_norm_defines_the_cluster_kernels(name):
    """One launch per direction: each block copies its rows into shared
    memory, writes its partials into its peers' shared memory and meets
    them at the cluster barrier."""
    text = _gn_source()
    assert re.search(rf"__global__ void __launch_bounds__\([^)]*\) {name}\(",
                     text)
    body = _kernel_text(text, name)
    for step in ("start_loads<T, V>(", "wait_piece(", "put_peer(",
                 "cluster_arrive();", "cluster_wait();", "group_sums("):
        assert step in body, step
    assert "cudaLaunchAttributeClusterDimension" in text
    # clusters of at most 8, the portable limit
    assert "NonPortableClusterSizeAllowed" not in text
    assert "cudaLaunchKernelEx(" in text
    assert "cudaOccupancyMaxActiveClusters(" in text


def test_group_norm_sets_the_shared_memory_limit_once():
    """A launch makes no attribute call: the cluster kernels' shared-memory
    limit is raised once per kernel and device, in ``smem_ready``, and
    both the launches and the occupancy query go through it."""
    text = re.sub(r"//[^\n]*", "", _gn_source())
    assert text.count("cudaFuncSetAttribute(") == 1
    body = text[text.index("cudaError_t smem_ready()"):]
    body = body[:body.index("\n}\n")]
    assert "cudaFuncSetAttribute(" in body and "done[dev] = true" in body
    for kernel in ("fwd_cluster_kernel<T, V>", "bwd_cluster_kernel<T, V>"):
        assert f"smem_ready<{kernel}>()" in text
    assert "smem_ready<Kernel>()" in text


def test_group_norm_has_no_atomics():
    text = re.sub(r"//[^\n]*", "", _gn_source())
    assert "atomic" not in text.lower()
    assert not re.search(r"\b(atom|red)\.(global|shared)", text)


@pytest.mark.parametrize("name", ["fwd_apply_kernel", "bwd_apply_kernel"])
def test_group_norm_apply_grids_no_longer_refold_the_tiles(name):
    """The two-pass route's apply blocks read the folded statistics (2G
    values an image); no apply block walks the tiles' partials."""
    body = _kernel_text(_gn_source(), name)
    assert "ntiles" not in body and "part" not in body
    assert "__global__ void __launch_bounds__(NT) fwd_fold_kernel(" \
        in _gn_source()
    assert "__global__ void __launch_bounds__(NT) bwd_fold_kernel(" \
        in _gn_source()


def test_ps_profile_classes_name_the_group_norm_kernels():
    """The PS profile's GroupNorm classes match every kernel that
    group_norm.cu defines and nothing it does not."""
    import chip_smoke

    defined = set(re.findall(r"__global__ void __launch_bounds__\([^)]*\) "
                             r"(\w+)\(", _gn_source()))
    classes = dict(chip_smoke.PS_CLASSES)
    marks = {m for name in ("group_norm_fwd", "group_norm_bwd")
             for m in classes[name]}
    assert {m.removeprefix("::") for m in marks} == defined
    assert {n for names in chip_smoke.GN_KERNELS.values()
            for n in names} == defined
    for name, names in chip_smoke.GN_KERNELS.items():
        assert all(n.startswith(name.rsplit("_", 1)[1]) for n in names)


def test_group_norm_c_layout_matches_the_plan():
    """``cluster_smem`` in the source and ``_cluster_smem`` in the
    wrapper name the same terms."""
    text = _gn_source()
    body = text[text.index("inline Smem cluster_smem("):]
    body = body[:body.index("\n}\n")]
    assert "nin == 1 ? 2LL * Cl + 2LL * Gl + 2LL * k * Gl" in body
    assert "2LL * Cl + 2LL * Gl + 2LL * k * Gl\n" in body
    assert "2LL * k * ((Cl + k - 1) / k)" in body
    assert "/ 128 * 128" in body
    from distkeras_tpu_torch.ops import group_norm as gn

    assert f"constexpr int NT = {gn.THREADS};" in text
    assert f"constexpr int SMEM_MAX = {gn.SMEM_PER_BLOCK};" in text
    assert f"constexpr int KMAX = {gn.KMAX};" in text
    assert gn.KMAX == 8
    assert f"(S > 1 && (C / S) * item < {gn.MIN_SPLIT_BYTES})" in text
