from libhpc_tpu_torch.runtime import native  # noqa: F401
