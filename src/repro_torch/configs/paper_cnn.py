"""The paper's own experimental configuration (port of
`repro/configs/paper_cnn.py`): 20 clients, 5 CNN families, Dir(alpha)
partitions of an image-classification dataset, NSGA-II with population
100 x 100 generations, ensemble size k=5.

(CIFAR-10/100 are not available offline; the data layer substitutes the
synthetic generator — DESIGN.md §2. Scale knobs are reduced by default;
pass full=True for the paper-faithful sizes.)
"""
from repro_torch.core.fedpae import FedPAEConfig
from repro_torch.core.nsga2 import NSGAConfig


def config(full: bool = False):
    if full:
        return {
            "n_clients": 20,
            "n_samples": 60000,
            "alphas": (0.5, 0.3, 0.1),
            "datasets": {"synthetic10": 10, "synthetic100": 100},
            "fedpae": FedPAEConfig(
                families=("cnn4", "vgg", "resnet", "densenet", "inception"),
                ensemble_k=5,
                nsga=NSGAConfig(pop_size=100, generations=100, k=5),
                max_epochs=60, patience=8),
        }
    return {
        "n_clients": 8,
        "n_samples": 6000,
        "alphas": (0.5, 0.3, 0.1),
        "datasets": {"synthetic10": 10},
        "fedpae": FedPAEConfig(
            families=("cnn4", "vgg", "resnet"),
            ensemble_k=3,
            nsga=NSGAConfig(pop_size=48, generations=40, k=3),
            max_epochs=15, patience=5, width=12),
    }


def smoke():
    cfg = config()
    cfg.update(n_clients=3, n_samples=900)
    return cfg
