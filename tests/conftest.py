def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (skips without one; run on the card with "
        "`python -m pytest -q -m cuda tests/test_torch_cuda.py`)",
    )
