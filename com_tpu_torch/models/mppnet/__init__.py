"""MPPNet (counterpart of ``com_tpu/models/mppnet``): the multi-frame
refinement head, its loss and target sampling, its transformer and
MPPNetE2E's memory bank."""
from .mppnet_e2e import (MemoryBank, MPPNetHeadE2E, init_bank,  # noqa: F401
                         mppnet_e2e_stream_step, push_bank)
from .mppnet_head import MPPNetHead, generate_trajectory, mppnet_loss  # noqa: F401
from .targets import MPPNetTargets, sample_mppnet_targets  # noqa: F401
from .transformer import MPPNetTransformer  # noqa: F401
