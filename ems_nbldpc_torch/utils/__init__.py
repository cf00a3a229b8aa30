from .stats import wilson_ci  # noqa: F401
