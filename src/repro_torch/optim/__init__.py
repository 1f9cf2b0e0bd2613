from repro_torch.optim.optimizers import (
    OptState,
    adamw_init,
    adamw_update,
    make_optimizer,
    sgdm_init,
    sgdm_update,
)
from repro_torch.optim.schedule import constant_lr, cosine_lr, warmup_cosine_lr

__all__ = [
    "OptState",
    "sgdm_init",
    "sgdm_update",
    "adamw_init",
    "adamw_update",
    "make_optimizer",
    "constant_lr",
    "cosine_lr",
    "warmup_cosine_lr",
]
