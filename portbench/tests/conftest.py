"""The benchmark's tests: ``python3 -m pytest -q portbench/tests`` from the
root of a checkout. Tests marked ``gpu`` need an NVIDIA GPU and skip
elsewhere; on the chip: ``python3 -m pytest -q -m gpu portbench/tests``."""


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU with CUDA")
