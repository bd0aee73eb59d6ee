"""The train half of ``tests/test_arch_smoke.py`` on the port, for the
SSM and hybrid archs: one train step in f32, in bf16 compute and with bf16
gradients, held against the JAX step (the SSD scan's gradients)
(``torch_train_parity.check_arch_step`` states the tolerances).  The
archs are split over files so that each file's JAX compiles fit one
worker's minute."""
import pytest

pytest.importorskip("torch")

from torch_train_parity import VARIANTS, check_arch_step  # noqa: E402

NAMES = ["hymba-1.5b", "mamba2-2.7b"]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", NAMES)
def test_arch_train_step_matches(name, variant):
    check_arch_step(name, variant)
