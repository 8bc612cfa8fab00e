"""Second-stage (RoI) heads and their shared plumbing: the proposal layer,
RoI target assignment, the heads of Voxel-RCNN, SECOND-IoU, the PV-RCNN
family and PointRCNN."""
from . import pointrcnn_head  # noqa: F401  (registers the heads)
from . import pvrcnn_head  # noqa: F401
from . import second_head  # noqa: F401
from . import voxelrcnn_head  # noqa: F401
