from .stats import binomial_ci, wilson_ci  # noqa: F401
