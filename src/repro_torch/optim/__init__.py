from .optimizers import make_optimizer, momentum, sgd  # noqa: F401
