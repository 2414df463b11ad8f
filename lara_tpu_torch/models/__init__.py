from lara_tpu_torch.models.lara import LaRaNet

__all__ = ["LaRaNet"]
