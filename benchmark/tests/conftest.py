def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; run with `pytest -m cuda benchmark/tests` on the GPU host")
