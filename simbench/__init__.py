"""Benchmark of the PyTorch and CUDA port (``ems_nbldpc_torch``) of the
NB-LDPC Monte-Carlo simulator.  ``python -m simbench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json``; see ``simbench/README.md``."""
