from repro_torch.optim.optimizers import (Optimizer, adamw, make_optimizer,
                                          sgd_momentum)
from repro_torch.optim.schedules import (cyclic_stage_lr, staged_lr,
                                         warmup_staged)

__all__ = ["Optimizer", "adamw", "sgd_momentum", "make_optimizer",
           "staged_lr", "warmup_staged", "cyclic_stage_lr"]
