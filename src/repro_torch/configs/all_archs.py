"""Import side-effect module: registers every assigned architecture."""

from . import (  # noqa: F401
    command_r_35b,
    deepseek_coder_33b,
    internvl2_1b,
    mamba2_370m,
    moonshot_v1_16b,
    phi3_mini_3p8b,
    phi3p5_moe_42b,
    recurrentgemma_2b,
    stablelm_12b,
    whisper_medium,
)
