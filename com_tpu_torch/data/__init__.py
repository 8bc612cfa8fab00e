"""The host input pipeline (the port's counterpart of ``com_tpu/data``):
datasets, augmentation with the COM samplers, processing, the fixed-shape
collate and the prefetching loader, all numpy on the host."""
from .dataset import DatasetTemplate, build_dataloader  # noqa: F401
from . import demo_dataset  # noqa: F401  (registers DemoDataset)
from . import synthetic  # noqa: F401  (registers SyntheticDataset)
from .waymo import waymo_dataset  # noqa: F401  (registers WaymoDataset)
