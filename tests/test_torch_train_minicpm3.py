"""Training parity (``tests/torch_train_parity.py``) at ``reduced()``
for minicpm3-4b (MLA)."""
import pytest

from torch_train_parity import check_arch


@pytest.mark.parametrize("arch", ["minicpm3-4b"])
def test_arch_train_step_matches_reference(arch, monkeypatch):
    check_arch(arch, monkeypatch)
