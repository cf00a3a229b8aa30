from .minconv import (  # noqa: F401
    ems_input_truncate,
    ems_output_saturate,
    fb_checknode_topk,
)
