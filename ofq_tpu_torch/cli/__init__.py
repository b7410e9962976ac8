"""The training, CGA and evaluation entry points (port of `ofq_tpu/cli/`)."""
