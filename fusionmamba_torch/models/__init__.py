from .fusion import VSSMFusion, VSSMFusionSeg

__all__ = ["VSSMFusion", "VSSMFusionSeg"]
