"""Training parity (``tests/torch_train_parity.py``) at ``reduced()``
for jamba-1.5-large-398b (mamba, attention and MoE, each MoE
layer on the reference's experts)."""
import pytest

from torch_train_parity import check_arch


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b"])
def test_arch_train_step_matches_reference(arch, monkeypatch):
    check_arch(arch, monkeypatch)
