"""Training (port of ``repro.train``): steps and the fault-tolerant loop."""
from repro_torch.train.loop import Trainer  # noqa: F401
from repro_torch.train.step import (  # noqa: F401
    init_train_state,
    make_eval_step,
    make_train_step,
)
