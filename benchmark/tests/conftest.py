import sys
from pathlib import Path

# the checkout's root, so that ``benchmark`` and the program import
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")
