from repro_torch.optim.adamw import AdamW  # noqa: F401
from repro_torch.optim.adafactor import Adafactor  # noqa: F401
from repro_torch.optim.schedule import make_schedule  # noqa: F401


def make_optimizer(name: str, lr_fn, weight_decay: float = 0.1):
    if name == "adamw":
        return AdamW(lr_fn, weight_decay=weight_decay)
    if name == "adafactor":
        return Adafactor(lr_fn, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")
