"""Assigned-architecture configs (one module per arch) + registry."""

from repro_torch.configs import (
    deepseek_moe_16b,
    gemma3_12b,
    h2o_danube_3_4b,
    mamba2_1_3b,
    mixtral_8x22b,
    musicgen_medium,
    paligemma_3b,
    qwen2_5_32b,
    starcoder2_15b,
    zamba2_2_7b,
)

REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen2_5_32b,
        starcoder2_15b,
        h2o_danube_3_4b,
        gemma3_12b,
        deepseek_moe_16b,
        mixtral_8x22b,
        zamba2_2_7b,
        paligemma_3b,
        mamba2_1_3b,
        musicgen_medium,
    )
}


def get(name: str):
    return REGISTRY[name]
