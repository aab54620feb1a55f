"""Apps of the PyTorch port; each runs as ``python -m graphmat_tpu_torch.apps.<name>``."""
