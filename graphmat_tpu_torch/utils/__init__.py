"""graphmat_tpu_torch.utils."""
