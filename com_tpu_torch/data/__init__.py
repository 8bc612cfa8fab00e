"""The host input pipeline (the port's counterpart of ``com_tpu/data``):
datasets, augmentation with the COM samplers, processing, the fixed-shape
collate and the prefetching loader, all numpy on the host.  The registered
datasets: DemoDataset, SyntheticDataset, CustomDataset, KittiDataset,
WaymoDataset, NuScenesDataset, LyftDataset and PandasetDataset, as
``com_tpu`` registers them."""
from .dataset import DatasetTemplate, build_dataloader  # noqa: F401
from . import demo_dataset  # noqa: F401  (registers DemoDataset)
from . import synthetic  # noqa: F401  (registers SyntheticDataset)
from .custom import custom_dataset  # noqa: F401  (registers CustomDataset)
from .kitti import kitti_dataset  # noqa: F401  (registers KittiDataset)
from .lyft import lyft_dataset  # noqa: F401  (registers LyftDataset)
from .nuscenes import nuscenes_dataset  # noqa: F401  (registers NuScenesDataset)
from .pandaset import pandaset_dataset  # noqa: F401  (registers PandasetDataset)
from .waymo import waymo_dataset  # noqa: F401  (registers WaymoDataset)
