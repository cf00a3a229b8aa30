from .code import NBCode  # noqa: F401
from . import formats  # noqa: F401
