from keto_tpu_torch.check.engine import CheckEngine

__all__ = ["CheckEngine"]
