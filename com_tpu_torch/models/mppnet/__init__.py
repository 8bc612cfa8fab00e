"""MPPNet (counterpart of ``com_tpu/models/mppnet``): the multi-frame
refinement head, its transformer and MPPNetE2E's memory bank."""
from .mppnet_e2e import (MemoryBank, MPPNetHeadE2E, init_bank,  # noqa: F401
                         mppnet_e2e_stream_step, push_bank)
from .mppnet_head import MPPNetHead  # noqa: F401
from .transformer import MPPNetTransformer  # noqa: F401
