import os
import sys

# tests see the ONE real CPU device (dry-run sets its own XLA_FLAGS in a
# subprocess); keep any preexisting flags out of the way.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; run on the card "
        "with `python -m pytest -m cuda tests/test_torch_*.py`")
