"""A kernel's least time on the chip from its shapes, one module per
kernel entry: ``bound_ms(f_active, g, dc, q, config) -> ms``, with
``f_active`` the frames the launch works on, ``g`` the rows of its
super-layer and ``config`` the configuration file."""
