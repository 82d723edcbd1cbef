"""Training parity (``tests/torch_train_parity.py``) at ``reduced()``
for deepseek-v2-lite-16b (MLA and MoE, each MoE layer on the
reference's experts)."""
import pytest

from torch_train_parity import check_arch


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b"])
def test_arch_train_step_matches_reference(arch, monkeypatch):
    check_arch(arch, monkeypatch)
