"""The port's example drivers (counterpart of ``syconn_tpu/examples/``).

The full-pipeline driver :mod:`syconn_tpu_torch.examples.start` is the
``syconn.example_torch`` console script and ``python -m
syconn_tpu_torch.examples.start``.
"""
