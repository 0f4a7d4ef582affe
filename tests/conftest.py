import os
import sys

# the dry-run is the ONLY place that forces 512 host devices; tests and
# benches must see the default 1 device (assignment requirement)
os.environ.pop("XLA_FLAGS", None)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped on hosts without one")
