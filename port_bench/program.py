"""The program's objects for a configuration file: the one place where the
benchmark's configuration keys meet the program's config classes."""

from __future__ import annotations

from typing import Any, Dict


def vlm_config(config: Dict[str, Any], dtype: str, aspect: str):
    """The program's `VLMConfig` for a configuration file, computing in
    `dtype`, images preprocessed by `aspect`."""
    from vila_tpu_torch.models import projector, qwen2, siglip, vlm

    llm, vis = config["llm"], config["vision"]
    lcfg = qwen2.LLMConfig(
        vocab_size=llm["vocab_size"], hidden_size=llm["hidden_size"],
        intermediate_size=llm["intermediate_size"], num_hidden_layers=llm["num_hidden_layers"],
        num_attention_heads=llm["num_attention_heads"],
        num_key_value_heads=llm["num_key_value_heads"], rope_theta=llm["rope_theta"],
        rms_norm_eps=llm["rms_norm_eps"], tie_word_embeddings=llm["tie_word_embeddings"],
        qkv_bias=llm["qkv_bias"], max_position_embeddings=llm["max_position_embeddings"],
        dtype=dtype)
    scfg = siglip.SigLIPConfig(
        hidden_size=vis["hidden_size"], intermediate_size=vis["intermediate_size"],
        num_hidden_layers=vis["num_hidden_layers"],
        num_attention_heads=vis["num_attention_heads"], image_size=vis["image_size"],
        patch_size=vis["patch_size"], layer_norm_eps=vis["layer_norm_eps"], dtype=dtype)
    pcfg = projector.ProjectorConfig(projector_type=config["projector"]["type"],
                                     mm_hidden_size=vis["hidden_size"],
                                     hidden_size=llm["hidden_size"], dtype=dtype)
    return vlm.VLMConfig(llm=lcfg, vision=scfg, projector=pcfg,
                         vision_feature_layer=vis["feature_layer"], vision_select="cls_patch",
                         image_aspect_ratio=aspect)
