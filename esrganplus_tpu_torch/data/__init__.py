from esrganplus_tpu_torch.data.datasets import LRDataset, LRHRDataset, create_dataset
from esrganplus_tpu_torch.data.loader import (DeviceFeeder, EvalLoader, TrainLoader, collate,
                                              create_dataloader)

__all__ = ["LRDataset", "LRHRDataset", "create_dataset", "create_dataloader", "TrainLoader",
           "EvalLoader", "DeviceFeeder", "collate"]
