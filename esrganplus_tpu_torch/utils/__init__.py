from esrganplus_tpu_torch.utils.misc import (mkdir_and_rename, set_random_seed,
                                             setup_logger, timestamp)

__all__ = ["mkdir_and_rename", "set_random_seed", "setup_logger", "timestamp"]
