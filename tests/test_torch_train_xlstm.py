"""Training parity (``tests/torch_train_parity.py``) at ``reduced()``
for xlstm-350m (mLSTM and sLSTM blocks)."""
import pytest

from torch_train_parity import check_arch


@pytest.mark.parametrize("arch", ["xlstm-350m"])
def test_arch_train_step_matches_reference(arch, monkeypatch):
    check_arch(arch, monkeypatch)
