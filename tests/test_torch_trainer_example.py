"""``repro_torch.examples.train_lm`` on the CPU through an injected
failure (split from ``test_torch_trainer.py``: a file of its own)."""
from repro_torch.examples import train_lm


def test_example_train_lm_runs_on_the_cpu(tmp_path):
    out = train_lm.main(["--steps", "3", "--ckpt", str(tmp_path),
                         "--inject-failure"], device="cpu")
    h = out["history"]
    assert len(h) == 3 and h[1].units == [8, 0] and h[2].units[1] > 0
