"""``repro_torch.launch.train`` on the CPU (split from
``test_torch_trainer.py``: the longest of its tests, in a file of its
own)."""
import numpy as np
import pytest

from repro_torch.launch import train as train_launch


def test_launch_train_runs_on_the_cpu(tmp_path):
    trainer, out = train_launch.main(
        ["--arch", "xlstm-350m", "--steps", "2", "--ckpt", str(tmp_path)],
        device="cpu")
    assert len(out["history"]) == 2 and trainer.device.type == "cpu"
    assert all(np.isfinite(r.loss) for r in out["history"])
    with pytest.raises(SystemExit):
        train_launch.main(["--arch", "whisper-tiny", "--steps", "1"],
                          device="cpu")
