"""The benchmark's tests: run them with ``python -m pytest
benchmark/tests`` (the repository's own suite is ``tests/``). Tests that
need a CUDA card carry the ``gpu`` marker and skip without one."""


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skips "
                                       "without one)")
