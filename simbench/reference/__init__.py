"""The plain reference that decides a run's ``correct``.

Plain NumPy and PyTorch, one module per decoder family (``spa``,
``list_ems``), found by the ``reference`` key of a configuration file.  It
imports nothing of the program under test (``ems_nbldpc_torch``) and takes
no table the program made: the GF tables, the row colouring, the encoder's
information set, the intrinsic costs and the decode are worked out here
again from the code matrix, the seed and the configuration.
"""
