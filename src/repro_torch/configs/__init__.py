"""Architecture registry: ``get_config(name)`` / ``get_config(name + '@smoke')``."""
from .base import (
    SHAPES,
    MLAConfig,
    ModelConfig,
    SSMConfig,
    ShapeConfig,
    cell_is_supported,
    get_config,
    list_archs,
)

# import for registration side effects
from . import (  # noqa: F401
    h2o_danube3_4b,
    internvl2_26b,
    jamba_1_5_large,
    llama3_8b,
    minicpm3_4b,
    mixtral_8x7b,
    olmoe_1b_7b,
    seamless_m4t_v2,
    stablelm_1_6b,
    xlstm_1_3b,
)

__all__ = [
    "SHAPES", "MLAConfig", "ModelConfig", "SSMConfig", "ShapeConfig",
    "cell_is_supported", "get_config", "list_archs",
]
