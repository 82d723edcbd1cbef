"""Training parity (``tests/torch_train_parity.py``) at ``reduced()``
for whisper-tiny (encoder-decoder: the stub
frames through the encoder, the decoder teacher-forced)."""
import pytest

from torch_train_parity import check_arch


@pytest.mark.parametrize("arch", ["whisper-tiny"])
def test_arch_train_step_matches_reference(arch, monkeypatch):
    check_arch(arch, monkeypatch)
