"""``scripts/flash_fwd_tc_variants.py`` times variants of the bf16 flash
forward kernel made by editing ``csrc/flash_fwd_tc.cu`` as text; it runs
only on a card, so these CPU tests hold its edits to the source as it
stands: each variant's texts are found, each variant differs from the
source, and its ptxas report is read as ptxas prints it."""

import importlib.util
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "flash_fwd_tc_variants", REPO / "scripts" / "flash_fwd_tc_variants.py")
variants = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(variants)

SOURCE = REPO / "deeplearning4j_tpu_torch" / "csrc" / "flash_fwd_tc.cu"


@pytest.mark.parametrize("name", sorted(variants.VARIANTS))
def test_variant_applies_to_the_kernel_source(name):
    src = SOURCE.read_text()
    out = variants.variant_source(name, src)
    assert (out == src) == (name == "as_built")


@pytest.mark.parametrize("name", sorted(set(variants.VARIANTS) - {"as_built"}))
def test_each_edit_replaces_one_place(name):
    # a text that occurs twice would turn two choices at once
    src = SOURCE.read_text()
    for old, _ in variants.VARIANTS[name]:
        assert src.count(old) == 1, old


def test_variants_refuse_a_source_without_the_texts():
    with pytest.raises(ValueError, match="no_overlap"):
        variants.variant_source("no_overlap", "int main() { return 0; }")


def test_ptxas_report_reads_registers_and_spills():
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_st
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 154 registers, used 1 barriers, 24 bytes smem, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi128EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi128EEEv14CUtensorMap_st
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 200 registers, used 1 barriers, 24 bytes smem, 1024 bytes cmem[0]
ptxas warning : Potential Performance Loss: wgmma.mma_async instructions are serialized
"""
    rep = variants.ptxas_report(log)
    assert rep["kernels"] == {
        "flash_fwd_wgmma_kernel<64>": {"spill_stores": 8, "spill_loads": 12, "registers": 154},
        "flash_fwd_wgmma_kernel<128>": {"spill_stores": 0, "spill_loads": 0, "registers": 200}}
    assert len(rep["wgmma_notes"]) == 1 and "serialized" in rep["wgmma_notes"][0]
