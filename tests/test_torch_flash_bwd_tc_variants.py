"""``scripts/flash_bwd_tc_variants.py`` times variants of the bf16 flash
backward kernels made by editing ``csrc/flash_bwd_tc.cu`` as text; it runs
only on a card, so these CPU tests hold its edits to the source as it
stands: each variant's texts are found, and each variant differs from the
source."""

import importlib.util
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "flash_bwd_tc_variants", REPO / "scripts" / "flash_bwd_tc_variants.py")
variants = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(variants)

SOURCE = REPO / "deeplearning4j_tpu_torch" / "csrc" / "flash_bwd_tc.cu"


@pytest.mark.parametrize("name", sorted(variants.VARIANTS))
def test_variant_applies_to_the_kernel_source(name):
    src = SOURCE.read_text()
    out = variants.variant_source(name, src)
    assert (out == src) == (name == "as_built")


def test_variants_refuse_a_source_without_the_texts():
    with pytest.raises(ValueError, match="branchy_elementwise"):
        variants.variant_source("branchy_elementwise", "int main() { return 0; }")
