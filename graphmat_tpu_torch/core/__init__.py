"""graphmat_tpu_torch.core."""
