from repro_torch.configs.base import (ModelConfig, InputShape, INPUT_SHAPES,
                                get_config, list_configs, register)
