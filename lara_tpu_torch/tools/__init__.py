"""Measurement scripts for the port, run on a CUDA machine from the
repository root (`python -m lara_tpu_torch.tools.<name>`)."""
