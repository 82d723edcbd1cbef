"""Training parity (``tests/torch_train_parity.py``) for the dense and
stub-frontend archs at ``reduced()``: h2o-danube-1.8b (sliding window),
command-r-35b, minitron-8b, chameleon-34b (stub embeddings)."""
import pytest

from torch_train_parity import check_arch


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "command-r-35b",
                                  "minitron-8b", "chameleon-34b"])
def test_arch_train_step_matches_reference(arch, monkeypatch):
    check_arch(arch, monkeypatch)
