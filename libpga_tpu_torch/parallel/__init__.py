"""Several populations on one device: the island model
(:mod:`libpga_tpu_torch.parallel.islands`), the torch counterpart of
``libpga_tpu/parallel/``."""
