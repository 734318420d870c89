"""Data sources of the port: the synthetic fixture (`synthetic`), the
real-image pipeline with the reference's splits (`pipeline`, `specs`,
`augment`; it needs OpenCV) and the device-resident pools
(`device_pool`)."""
from uaps_tpu_torch.data.pipeline import DefectDataset
from uaps_tpu_torch.data.synthetic import SyntheticDefects, synthetic_batch

__all__ = ["DefectDataset", "SyntheticDefects", "synthetic_batch"]
