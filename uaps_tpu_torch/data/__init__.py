"""Data sources of the port: the synthetic fixture. The real-image pipeline
(`uaps_tpu/data/pipeline.py`) is not ported yet."""
from uaps_tpu_torch.data.synthetic import SyntheticDefects, synthetic_batch


class DefectDataset:
    """The real-image pipeline, not ported yet: JAX's decodes and augments
    with cv2 (uaps_tpu/data/augment.py)."""

    def __init__(self, cfg, seed: int = 0):
        raise NotImplementedError(
            f"dataset {cfg.name!r}: the image pipeline is not ported yet "
            "(ROADMAP.md Queue A, 'The real-image pipeline'); train on "
            "'--dataset synthetic'")


__all__ = ["DefectDataset", "SyntheticDefects", "synthetic_batch"]
