"""Self-contained HF remote code for VILA-style multimodal checkpoints
exported by vila_tpu (single-repo `trust_remote_code` artifact — the
capability of llava/remote_code/modeling_vila.py:506 / auto_processor.py:148,
re-written from scratch for the vila_tpu export layout).

Loads with stock transformers:

    model = AutoModel.from_pretrained(repo, trust_remote_code=True)
    out = model(input_ids, pixel_values=..., media_positions=...)
    ids = model.generate(input_ids, pixel_values=..., media_positions=...)

Weight layout: one state dict with `llm.*` (an AutoModelForCausalLM),
`vision_tower.*` (an AutoModel vision encoder) and `mm_projector.layers.*`
(the projector Sequential) prefixes.
"""

from typing import List, Optional, Sequence, Union

import torch
import torch.nn as nn
from transformers import (
    AutoConfig,
    AutoModel,
    AutoModelForCausalLM,
    AutoTokenizer,
    PretrainedConfig,
    PreTrainedModel,
)


class VILAConfig(PretrainedConfig):
    model_type = "vila"

    def __init__(
        self,
        llm_config=None,
        vision_config=None,
        projector_spec=None,
        vision_feature_layer: int = -2,
        vision_select: str = "cls_patch",
        tokens_per_image: int = 0,
        image_token: str = "<image>",
        image_size: int = 448,
        image_mean=(0.5, 0.5, 0.5),
        image_std=(0.5, 0.5, 0.5),
        **kwargs,
    ):
        self.llm_config = llm_config or {}
        self.vision_config = vision_config or {}
        # projector_spec: [[op, din, dout], ...] with op in
        # down2|down3|ln|linear|gelu — the reference projector Sequential
        # (multimodal_projector/base_projector.py) as data.
        self.projector_spec = projector_spec or []
        self.vision_feature_layer = vision_feature_layer
        self.vision_select = vision_select
        self.tokens_per_image = tokens_per_image
        self.image_token = image_token
        self.image_size = image_size
        self.image_mean = list(image_mean)
        self.image_std = list(image_std)
        super().__init__(**kwargs)


class _Down(nn.Module):
    """Pixel-unshuffle token downsample (flat_square semantics)."""

    def __init__(self, r: int):
        super().__init__()
        self.r = r

    def forward(self, x):
        n, s, c = x.shape
        side = int(s**0.5)
        x = x.reshape(n, side, side, c).contiguous()
        r = self.r
        w = h = side
        if w % r:
            x = torch.cat(
                [x, x.new_zeros((n, r - w % r, h, c))], dim=1
            ).contiguous()
            n, w, h, c = x.size()
        if h % r:
            x = torch.cat(
                [x, x.new_zeros((n, w, r - h % r, c))], dim=2
            ).contiguous()
            n, w, h, c = x.size()
        x = x.view(n, w, int(h / r), int(c * r))
        x = x.permute(0, 2, 1, 3).contiguous()
        x = x.view(n, int(h / r), int(w / r), int(c * r * r))
        x = x.permute(0, 2, 1, 3).contiguous()
        return x.reshape(n, -1, x.shape[-1])


class VILAProjector(nn.Module):
    def __init__(self, spec: Sequence[Sequence]):
        super().__init__()
        mods: List[nn.Module] = []
        for op, din, dout in spec:
            if op == "down2":
                mods.append(_Down(2))
            elif op == "down3":
                mods.append(_Down(3))
            elif op == "ln":
                mods.append(nn.LayerNorm(din))
            elif op == "linear":
                mods.append(nn.Linear(din, dout))
            elif op == "gelu":
                mods.append(nn.GELU())
            else:
                raise ValueError(f"unknown projector op {op!r}")
        self.layers = nn.Sequential(*mods)

    def forward(self, x):
        return self.layers(x)


def _sub_config(d: dict) -> PretrainedConfig:
    d = dict(d)
    model_type = d.pop("model_type")
    d.pop("architectures", None)
    d.pop("ps3_trunk_only", None)
    return AutoConfig.for_model(model_type, **d)


class _RMSNorm(nn.Module):
    """Full-width RMS norm (InternViT qk normalization semantics —
    vila_tpu/models/vit.py:290 normalizes the concatenated head dim)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        var = x.float().pow(2).mean(-1, keepdim=True)
        return (x.float() * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


class _ViTBlock(nn.Module):
    def __init__(self, d, inter, heads, eps, act, layer_scale, qk_norm):
        super().__init__()
        self.heads = heads
        self.ln1 = nn.LayerNorm(d, eps=eps)
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)
        self.ln2 = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, inter)
        self.fc2 = nn.Linear(inter, d)
        self.act = act
        if layer_scale:
            self.ls1 = nn.Parameter(torch.ones(d) * 0.1)
            self.ls2 = nn.Parameter(torch.ones(d) * 0.1)
        if qk_norm:
            self.q_norm = _RMSNorm(d, eps)
            self.k_norm = _RMSNorm(d, eps)

    def forward(self, h):
        b, s, d = h.shape
        hd = d // self.heads
        x = self.ln1(h)
        q, k, v = self.q(x), self.k(x), self.v(x)
        if hasattr(self, "q_norm"):
            q, k = self.q_norm(q), self.k_norm(k)
        q = q.view(b, s, self.heads, hd).transpose(1, 2)
        k = k.view(b, s, self.heads, hd).transpose(1, 2)
        v = v.view(b, s, self.heads, hd).transpose(1, 2)
        a = torch.nn.functional.scaled_dot_product_attention(q, k, v)
        a = self.out(a.transpose(1, 2).reshape(b, s, d))
        if hasattr(self, "ls1"):
            a = a * self.ls1
        h = h + a
        x = self.fc2(self.act(self.fc1(self.ln2(h))))
        if hasattr(self, "ls2"):
            x = x * self.ls2
        return h + x


class VILAGenericViT(nn.Module):
    """Self-contained pre-norm ViT covering the CLIP / InternViT / RADIO
    tower family (vila_tpu/models/vit.py semantics) — these towers have no
    stock transformers class, so the remote code carries its own."""

    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["hidden_size"]
        patch = cfg["patch_size"]
        eps = cfg.get("layer_norm_eps", 1e-5)
        n_pos = (cfg["image_size"] // patch) ** 2 + (
            1 if cfg.get("class_token", True) else 0
        )
        act_name = cfg.get("hidden_act", "gelu")
        act = (
            (lambda x: x * torch.sigmoid(1.702 * x))
            if act_name == "quick_gelu"
            else nn.GELU()
        )
        self.patch = patch
        self.patch_embed = nn.Linear(patch * patch * 3, d, bias=False)
        self.pos_embed = nn.Parameter(torch.zeros(n_pos, d))
        if cfg.get("class_token", True):
            self.class_embedding = nn.Parameter(torch.zeros(d))
        if cfg.get("pre_layernorm", False):
            self.pre_ln = nn.LayerNorm(d, eps=eps)
        self.blocks = nn.ModuleList(
            _ViTBlock(
                d, cfg["intermediate_size"], cfg["num_attention_heads"],
                eps, act, cfg.get("layer_scale", False),
                cfg.get("qk_norm", False),
            )
            for _ in range(cfg["num_hidden_layers"])
        )
        self.post_ln = nn.LayerNorm(d, eps=eps)

        from types import SimpleNamespace

        self.config = SimpleNamespace(
            image_size=cfg["image_size"], patch_size=patch,
            hidden_size=d,
        )

    def forward(self, pixel_values, output_hidden_states=False, **kw):
        # (N, 3, H, W) -> (N, tokens, P*P*3) with vit.patchify's
        # (row, col, channel) flattening order
        x = pixel_values.permute(0, 2, 3, 1)
        b, hh, ww, c = x.shape
        p = self.patch
        x = x.reshape(b, hh // p, p, ww // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(
            b, (hh // p) * (ww // p), p * p * c
        )
        h = self.patch_embed(x.to(self.patch_embed.weight.dtype))
        if hasattr(self, "class_embedding"):
            cls = self.class_embedding.expand(b, 1, -1)
            h = torch.cat([cls, h], dim=1)
        pos = self.pos_embed
        if pos.shape[0] != h.shape[1]:  # 1-D linear resize (siglip.py:
            idx = torch.linspace(0, pos.shape[0] - 1, h.shape[1])
            lo = idx.floor().long().clamp(0, pos.shape[0] - 1)
            hi = idx.ceil().long().clamp(0, pos.shape[0] - 1)
            frac = (idx - lo).unsqueeze(-1).to(pos.dtype)
            pos = pos[hi] * frac + pos[lo] * (1 - frac)
        h = h + pos.unsqueeze(0)
        if hasattr(self, "pre_ln"):
            h = self.pre_ln(h)
        hidden_states = [h]
        for blk in self.blocks:
            h = blk(h)
            hidden_states.append(h)
        from types import SimpleNamespace

        return SimpleNamespace(
            last_hidden_state=self.post_ln(h),
            hidden_states=tuple(hidden_states) if output_hidden_states else None,
        )


class VILAForCausalLM(PreTrainedModel):
    config_class = VILAConfig
    supports_gradient_checkpointing = True
    _supports_flash_attn_2 = False

    def __init__(self, config: VILAConfig):
        super().__init__(config)
        self.llm = AutoModelForCausalLM.from_config(
            _sub_config(config.llm_config)
        )
        if config.vision_config.get("model_type") == "vila_vit":
            # CLIP/InternViT/RADIO family: no stock transformers class
            self.vision_tower = VILAGenericViT(config.vision_config)
        else:
            self.vision_tower = AutoModel.from_config(
                _sub_config(config.vision_config)
            )
        self.mm_projector = VILAProjector(config.projector_spec)
        self.post_init()

    def get_input_embeddings(self):
        return self.llm.get_input_embeddings()

    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) normalized pixels -> (N, T, D) LLM-space tokens."""
        out = self.vision_tower(pixel_values, output_hidden_states=True)
        h = out.hidden_states[self.config.vision_feature_layer]
        vc = self.vision_tower.config
        num_patches = (vc.image_size // vc.patch_size) ** 2
        if self.config.vision_select == "patch" and h.shape[1] == num_patches + 1:
            h = h[:, 1:]  # CLIP-family towers carry a CLS token
        return self.mm_projector(h.to(self.dtype))

    def _embed(
        self,
        input_ids: torch.Tensor,  # (B, S)
        pixel_values: Optional[torch.Tensor],
        media_positions: Optional[torch.Tensor],  # (M,) flat B*S indices
    ) -> torch.Tensor:
        embeds = self.get_input_embeddings()(input_ids)
        if pixel_values is not None and media_positions is not None:
            feats = self.encode_images(pixel_values)
            flat = feats.reshape(-1, feats.shape[-1])
            b, s, d = embeds.shape
            out = embeds.reshape(b * s, d).clone()
            pos = media_positions.reshape(-1).to(out.device)
            out[pos] = flat[: pos.shape[0]].to(out.dtype)
            embeds = out.reshape(b, s, d)
        return embeds

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        pixel_values: Optional[torch.Tensor] = None,
        media_positions: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        **kwargs,
    ):
        if inputs_embeds is None:
            inputs_embeds = self._embed(input_ids, pixel_values, media_positions)
        return self.llm(
            inputs_embeds=inputs_embeds,
            attention_mask=attention_mask,
            labels=labels,
            **kwargs,
        )

    @torch.no_grad()
    def generate(
        self,
        input_ids: Optional[torch.Tensor] = None,
        pixel_values: Optional[torch.Tensor] = None,
        media_positions: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        **kwargs,
    ):
        inputs_embeds = self._embed(input_ids, pixel_values, media_positions)
        return self.llm.generate(
            inputs_embeds=inputs_embeds,
            attention_mask=attention_mask,
            **kwargs,
        )


class VILAProcessor:
    """Minimal processor: chat text + PIL/ndarray images -> model inputs.

    Replicates the vila_tpu host pipeline's resize path: each
    `config.image_token` in the text expands to `tokens_per_image`
    placeholder ids followed by a newline; images resize to
    `config.image_size` squares and normalize with the config stats.
    """

    def __init__(self, tokenizer, config: VILAConfig):
        self.tokenizer = tokenizer
        self.config = config
        self.image_token_id = tokenizer.convert_tokens_to_ids(
            config.image_token
        )

    @classmethod
    def from_pretrained(cls, path, **kwargs):
        return cls(
            AutoTokenizer.from_pretrained(path),
            VILAConfig.from_pretrained(path),
        )

    def _preprocess_image(self, image) -> torch.Tensor:
        import numpy as np

        if not isinstance(image, np.ndarray):
            image = np.asarray(image.convert("RGB"))
        size = self.config.image_size
        try:
            from PIL import Image as PILImage

            pil = PILImage.fromarray(image).resize(
                (size, size), PILImage.BICUBIC
            )
            image = np.asarray(pil)
        except ImportError:  # nearest-neighbour fallback
            ys = (np.arange(size) * image.shape[0] // size).clip(
                0, image.shape[0] - 1
            )
            xs = (np.arange(size) * image.shape[1] // size).clip(
                0, image.shape[1] - 1
            )
            image = image[ys][:, xs]
        x = image.astype("float32") / 255.0
        mean = np.asarray(self.config.image_mean, "float32")
        std = np.asarray(self.config.image_std, "float32")
        x = (x - mean) / std
        return torch.tensor(x.transpose(2, 0, 1))

    def __call__(
        self,
        text: str,
        images: Union[None, list] = None,
        return_tensors: str = "pt",
    ):
        tok = self.tokenizer
        nl = tok("\n", add_special_tokens=False).input_ids
        parts = text.split(self.config.image_token)
        ids: List[int] = []
        positions: List[int] = []
        for i, part in enumerate(parts):
            if i > 0:
                start = len(ids)
                positions.extend(
                    range(start, start + self.config.tokens_per_image)
                )
                ids.extend(
                    [self.image_token_id] * self.config.tokens_per_image
                )
                ids.extend(nl)
            ids.extend(tok(part, add_special_tokens=False).input_ids)
        out = {
            "input_ids": torch.tensor([ids], dtype=torch.long),
            "attention_mask": torch.ones((1, len(ids)), dtype=torch.long),
        }
        if images:
            out["pixel_values"] = torch.stack(
                [self._preprocess_image(im) for im in images]
            )
            out["media_positions"] = torch.tensor(positions, dtype=torch.long)
        return out


VILAConfig.register_for_auto_class()
VILAForCausalLM.register_for_auto_class("AutoModel")
VILAForCausalLM.register_for_auto_class("AutoModelForCausalLM")
