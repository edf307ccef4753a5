"""Seeded weights of an NVILA configuration, made on the device.

Each tensor is drawn by one `torch.randn` call from a generator of its own,
seeded by (run seed, tensor path), in the type it is served or trained in.
So the program's set-up and the plain reference, which runs after the
program's state is freed, make the same values without keeping a copy, and
the reference can draw one tensor at a time. Decoder layers are stacked on
a leading axis (the program's tree layout); kernels are (din, dout).

Draws: kernels, embeddings and biases N(0, std^2); norm scales
1 + jitter * N(0, 1), so that a norm's scale is exercised; LayerNorm
biases N(0, std^2).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from port_bench.harness import derive_seed

Spec = List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]  # (path, shape, kind)


def llm_spec(llm: Dict[str, Any]) -> Spec:
    L, D, I = llm["num_hidden_layers"], llm["hidden_size"], llm["intermediate_size"]
    hq, hkv = llm["num_attention_heads"], llm["num_key_value_heads"]
    hd = D // hq
    lay = ("layers",)
    spec: Spec = [
        (("embed_tokens", "embedding"), (llm["vocab_size"], D), "normal"),
        (lay + ("input_layernorm", "scale"), (L, D), "norm"),
        (lay + ("q_proj", "kernel"), (L, D, hq * hd), "normal"),
        (lay + ("k_proj", "kernel"), (L, D, hkv * hd), "normal"),
        (lay + ("v_proj", "kernel"), (L, D, hkv * hd), "normal"),
        (lay + ("o_proj", "kernel"), (L, hq * hd, D), "normal"),
        (lay + ("post_attention_layernorm", "scale"), (L, D), "norm"),
        (lay + ("gate_proj", "kernel"), (L, D, I), "normal"),
        (lay + ("up_proj", "kernel"), (L, D, I), "normal"),
        (lay + ("down_proj", "kernel"), (L, I, D), "normal"),
        (("norm", "scale"), (D,), "norm"),
    ]
    if llm.get("qkv_bias", True):
        spec += [(lay + (n, "bias"), (L, w), "normal")
                 for n, w in (("q_proj", hq * hd), ("k_proj", hkv * hd), ("v_proj", hkv * hd))]
    if not llm["tie_word_embeddings"]:
        spec.append((("lm_head", "kernel"), (D, llm["vocab_size"]), "normal"))
    return spec


def siglip_spec(vis: Dict[str, Any]) -> Spec:
    L, D, I = vis["num_hidden_layers"], vis["hidden_size"], vis["intermediate_size"]
    p = vis["patch_size"]
    n = (vis["image_size"] // p) ** 2
    lay = ("layers",)
    spec: Spec = [
        (("patch_embedding", "kernel"), (p * p * 3, D), "normal"),
        (("patch_embedding", "bias"), (D,), "normal"),
        (("position_embedding", "embedding"), (n, D), "normal"),
        (("post_layernorm", "scale"), (D,), "norm"),
        (("post_layernorm", "bias"), (D,), "normal"),
    ]
    for ln in ("layer_norm1", "layer_norm2"):
        spec += [(lay + (ln, "scale"), (L, D), "norm"), (lay + (ln, "bias"), (L, D), "normal")]
    for name, din, dout in (("q_proj", D, D), ("k_proj", D, D), ("v_proj", D, D),
                            ("out_proj", D, D), ("fc1", D, I), ("fc2", I, D)):
        spec += [(lay + (name, "kernel"), (L, din, dout), "normal"),
                 (lay + (name, "bias"), (L, dout), "normal")]
    return spec


def projector_spec(mm_hidden: int, hidden: int) -> Spec:
    """`mlp_downsample`: 2x2 unshuffle, LayerNorm, linear, GELU, linear,
    keyed by the reference's nn.Sequential indices."""
    return [
        (("1", "scale"), (4 * mm_hidden,), "norm"),
        (("1", "bias"), (4 * mm_hidden,), "normal"),
        (("2", "kernel"), (4 * mm_hidden, hidden), "normal"),
        (("2", "bias"), (hidden,), "normal"),
        (("4", "kernel"), (hidden, hidden), "normal"),
        (("4", "bias"), (hidden,), "normal"),
    ]


def vlm_spec(config: Dict[str, Any]) -> Dict[str, Spec]:
    if config["projector"]["type"] != "mlp_downsample":
        raise ValueError(f"projector {config['projector']['type']!r} has no weight spec")
    return {"llm": llm_spec(config["llm"]),
            "vision_tower": siglip_spec(config["vision"]),
            "mm_projector": projector_spec(config["vision"]["hidden_size"],
                                           config["llm"]["hidden_size"])}


def draw(torch, seed: int, component: str, path: Tuple[str, ...], shape, kind: str,
         init: Dict[str, float], device, dtype):
    """One tensor of the tree, the same on every call with these arguments."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "weights", component, *path))
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    if kind == "norm":
        return t.mul_(init["norm_jitter"]).add_(1.0)
    return t.mul_(init["std"])


def set_path(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def component(torch, config: Dict[str, Any], seed: int, name: str, device, dtype):
    """One component's tree ("llm", "vision_tower" or "mm_projector")."""
    tree: Dict[str, Any] = {}
    for path, shape, kind in vlm_spec(config)[name]:
        set_path(tree, path, draw(torch, seed, name, path, shape, kind, config["weights"],
                                  device, dtype))
    return tree


def vlm_tree(torch, config: Dict[str, Any], seed: int, device, dtype) -> Dict[str, Any]:
    return {name: component(torch, config, seed, name, device, dtype)
            for name in ("llm", "vision_tower", "mm_projector")}
