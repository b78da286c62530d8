"""Architecture configs (port of ``repro.configs``): the 10 assigned
architectures, registered by importing :mod:`.archs`, and the paper's
own models (:mod:`.paper`).  ``get_config(name)`` resolves an assigned
architecture by id."""

from repro_torch.configs.base import (ArchConfig, BlockDesc, MoECfg, MLACfg,
                                      MambaCfg, layer_plan, register,
                                      get_config, list_configs)

# Import for registration side effects.
from repro_torch.configs import archs as _archs  # noqa: F401

__all__ = ["ArchConfig", "BlockDesc", "MoECfg", "MLACfg", "MambaCfg",
           "layer_plan", "register", "get_config", "list_configs"]
