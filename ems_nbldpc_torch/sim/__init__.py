from .mc import MonteCarlo, SimConfig, SimResult  # noqa: F401
