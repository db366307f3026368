"""Online perception nets, counterparts of the JAX package's `models/`.

Their outputs fill the same `FrameInput` slots as the offline artifacts
of `io/perception.py`:
  * `solov2`     - instance segmentation + MatrixNMS  (det2d)
  * `stereo_net` - correlation-volume disparity       (stereo)
  * `det3d`      - FCOS3D-style monocular 3D boxes    (det3d)
  * `raft`       - recurrent dense optical flow       (flow)
  * `reid`       - appearance embeddings for MOT      (mot)
Convolutions run through cuDNN with TF32 off (`utils/precision`).
"""

from dynamic_vins_tpu_torch.models.det3d import OnlineDetector3D
from dynamic_vins_tpu_torch.models.raft import OnlineFlowEstimator
from dynamic_vins_tpu_torch.models.reid import ReidExtractor
from dynamic_vins_tpu_torch.models.solov2 import OnlineDetector2D
from dynamic_vins_tpu_torch.models.stereo_net import OnlineStereoMatcher

__all__ = ["OnlineDetector2D", "OnlineDetector3D",
           "OnlineStereoMatcher", "OnlineFlowEstimator",
           "ReidExtractor"]
