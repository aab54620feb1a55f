"""graphmat_tpu_torch.io."""
