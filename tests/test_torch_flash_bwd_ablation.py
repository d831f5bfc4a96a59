"""``scripts/flash_bwd_ablation.py`` times variants of the flash backward
kernels made by editing ``csrc/flash_bwd.cu`` as text; it runs only on a
card, so these CPU tests hold its edits to the source as it stands: each
variant's texts are found, and each variant differs from the source."""

import importlib.util
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "flash_bwd_ablation", REPO / "scripts" / "flash_bwd_ablation.py")
ablation = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ablation)

SOURCE = REPO / "deeplearning4j_tpu_torch" / "csrc" / "flash_bwd.cu"


@pytest.mark.parametrize("name", sorted(ablation.VARIANTS))
def test_ablation_variant_applies_to_the_kernel_source(name):
    src = SOURCE.read_text()
    out = ablation.variant_source(name, src)
    assert (out == src) == (name == "as_built")


def test_ablation_refuses_a_source_without_the_texts():
    with pytest.raises(ValueError, match="no_exp"):
        ablation.variant_source("no_exp", "int main() { return 0; }")
