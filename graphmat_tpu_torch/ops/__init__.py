"""graphmat_tpu_torch.ops."""
