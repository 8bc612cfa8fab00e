"""Second-stage (RoI) heads and their shared plumbing: the proposal layer,
RoI target assignment, the heads of Voxel-RCNN, SECOND-IoU, the PV-RCNN
family, PointRCNN and PartA2; MPPNet's heads live in ``models/mppnet``."""
from .. import mppnet  # noqa: F401  (registers MPPNetHead, MPPNetHeadE2E)
from . import parta2_head  # noqa: F401  (registers the heads)
from . import pointrcnn_head  # noqa: F401
from . import pvrcnn_head  # noqa: F401
from . import second_head  # noqa: F401
from . import voxelrcnn_head  # noqa: F401
