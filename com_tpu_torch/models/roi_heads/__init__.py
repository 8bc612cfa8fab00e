"""Second-stage (RoI) heads and their shared plumbing: the proposal layer,
RoI target assignment, Voxel-RCNN's and SECOND-IoU's heads."""
from . import pvrcnn_head  # noqa: F401  (registers the heads)
from . import second_head  # noqa: F401
from . import voxelrcnn_head  # noqa: F401
