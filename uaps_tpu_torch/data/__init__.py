"""Data sources of the port: the synthetic fixture. The real-image pipeline
(`uaps_tpu/data/pipeline.py`) needs cv2, which the GPU machine lacks."""
from uaps_tpu_torch.data.synthetic import SyntheticDefects, synthetic_batch


class DefectDataset:
    """The real-image pipeline, not ported: it decodes and augments with
    cv2 (uaps_tpu/data/augment.py), which the GPU machine does not have."""

    def __init__(self, cfg, seed: int = 0):
        raise NotImplementedError(
            f"dataset {cfg.name!r}: the image pipeline needs cv2 and is not "
            "ported yet (ROADMAP.md Queue A, 'The rest of the Trainer and "
            "CLIs'); train on "
            "'--dataset synthetic'")


__all__ = ["DefectDataset", "SyntheticDefects", "synthetic_batch"]
