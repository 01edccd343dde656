from .optimizers import (adafactor, adamw, make_optimizer,  # noqa: F401
                         momentum, sgd)
from .schedules import constant, cosine, warmup_cosine  # noqa: F401
