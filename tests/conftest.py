import pytest


def pytest_configure(config):
    # mirrors [tool.pytest.ini_options] markers in pyproject.toml so the
    # suite also runs standalone (e.g. pytest invoked from another rootdir)
    config.addinivalue_line(
        "markers",
        "slow: long-running tier (multi-device subprocess tests, the 60s "
        "mobv3 wall-time guard, hypothesis-heavy equivalence sweeps); "
        "PR CI runs -m 'not slow', the push-to-main full job runs all")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card with nvcc (the PyTorch port's CUDA "
        "kernels); skips elsewhere")
