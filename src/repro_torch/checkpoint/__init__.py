"""Checkpoints of any tree of tensors: manifest + npz, sync and async
(:mod:`repro_torch.checkpoint.ckpt`)."""
