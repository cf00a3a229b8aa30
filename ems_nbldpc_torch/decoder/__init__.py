from .api import DecoderConfig, decode  # noqa: F401
from .graph import DeviceGraph  # noqa: F401
