from dynamic_vins_tpu_torch.loop.closure import (KeyframeDatabase,
                                                 LoopCloser,
                                                 LoopClosureConfig, LoopEdge)

__all__ = ["KeyframeDatabase", "LoopCloser", "LoopClosureConfig",
           "LoopEdge"]
