"""Device operators of the PyTorch port, one module per `libav_tpu/ops`
module it replaces."""
