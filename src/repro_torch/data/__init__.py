from .partition import dirichlet_partition, split_train_val_test  # noqa: F401
from .synthetic import SyntheticImageDataset, make_synthetic_images  # noqa: F401
from .tokens import TokenPipeline, synthetic_token_batch  # noqa: F401
