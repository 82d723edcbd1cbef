"""Training parity (``tests/torch_train_parity.py``) at ``reduced()``
for kimi-k2-1t-a32b (MoE, each layer on the reference's
experts)."""
import pytest

from torch_train_parity import check_arch


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b"])
def test_arch_train_step_matches_reference(arch, monkeypatch):
    check_arch(arch, monkeypatch)
