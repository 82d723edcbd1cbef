"""The port's trainer through a failure and a restart, on the CPU's
simulated pair: the reference's ``tests/test_trainer_ft.py`` kill /
revive and restart tests (split from ``test_torch_trainer.py``)."""
import numpy as np

from repro_torch.ft.failure import FailureInjector
from torch_trainer_common import make_trainer


def test_failure_kill_and_elastic_revive(tmp_path):
    inj = FailureInjector(kill={2: "host"}, revive={4: "host"})
    out = make_trainer(str(tmp_path), steps=6, injector=inj).run()
    h = {r.step: r for r in out["history"]}
    assert h[2].units == [8, 0]          # dead group gets nothing
    assert h[3].units == [8, 0]
    assert h[4].units[1] > 0             # rejoined after revive
    assert all(np.isfinite(r.loss) for r in out["history"])
    assert all(np.isfinite(r.grad_norm) and r.wall_s > 0
               for r in out["history"])


def test_checkpoint_restart_resumes(tmp_path):
    make_trainer(str(tmp_path), steps=4).run()
    out = make_trainer(str(tmp_path), steps=7).run()
    assert out["history"][0].step == 4   # resumed, not restarted
