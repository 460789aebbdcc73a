"""Settings of the benchmark's tests: the ``cuda`` marker (tests that need
the card skip here, deciding in a fixture)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped without one")
