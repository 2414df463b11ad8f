"""Data and tensor parallelism, the counterpart of `lara_tpu/parallel` (its
dp×tp mesh and multi-host initialisation) in `torch.distributed`: one
process per device, NCCL between CUDA devices and gloo on the CPU."""
