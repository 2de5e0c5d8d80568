from dyffusion_tpu_torch.data.base import DataModule, DatasetSplit, build_examples
from dyffusion_tpu_torch.data.physical_systems import PhysicalSystemsDataModule, write_fake_benchmark_dir
from dyffusion_tpu_torch.data.synthetic import SyntheticDataModule, make_synthetic_trajectories

__all__ = [
    "DataModule",
    "DatasetSplit",
    "PhysicalSystemsDataModule",
    "SyntheticDataModule",
    "build_examples",
    "make_synthetic_trajectories",
    "write_fake_benchmark_dir",
]
