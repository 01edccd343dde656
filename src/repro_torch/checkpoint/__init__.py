from .store import CheckpointStore, load_pytree, save_pytree  # noqa: F401
