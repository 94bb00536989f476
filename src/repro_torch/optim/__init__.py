from repro_torch.optim.first_order import (  # noqa: F401
    SGD,
    Adam,
    AdamState,
    Optimizer,
)
