from dyffusion_tpu_torch.data.base import DataModule, DatasetSplit, build_examples, get_dims_of_dataset
from dyffusion_tpu_torch.data.oisstv2 import OISSTv2DataModule, write_fake_oisst_dir
from dyffusion_tpu_torch.data.physical_systems import PhysicalSystemsDataModule, write_fake_benchmark_dir
from dyffusion_tpu_torch.data.synthetic import SyntheticDataModule, make_synthetic_trajectories

__all__ = [
    "DataModule",
    "DatasetSplit",
    "OISSTv2DataModule",
    "PhysicalSystemsDataModule",
    "SyntheticDataModule",
    "build_examples",
    "get_dims_of_dataset",
    "make_synthetic_trajectories",
    "write_fake_benchmark_dir",
    "write_fake_oisst_dir",
]
