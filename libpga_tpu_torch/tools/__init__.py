"""Measurement tools of the port that run on a CUDA card:
``ablate_floor`` and ``ablate_kernel``, the floor harness of the
one-generation breed (run as ``python -m libpga_tpu_torch.tools.<name>``)."""
