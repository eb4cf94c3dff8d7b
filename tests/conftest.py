import os
import sys

# Smoke tests and benches must see 1 device — do NOT set
# xla_force_host_platform_device_count here.  Multi-device tests live in
# tests/multidev/ and are launched in a subprocess with their own XLA_FLAGS
# (see test_multidev_launcher.py).
collect_ignore_glob = (
    [] if os.environ.get("REPRO_MULTIDEV") == "1" else ["multidev/*"]
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() is False")
