"""Needle-in-a-haystack over a sequence-parallel mesh, as
`vila_tpu/eval/niah.py` (the reference's `llava/eval/vision_niah_vila/`:
haystack embeddings from the vision tower over frames, a needle block, and
the accuracy grid over (context length, needle depth) of eval_vision_niah.py,
which runs zigzag ring attention over several devices).

Every rank holds the whole embedding sequence and forwards its sequence
shard (zigzag when the layout applies) with MM-SP attention in every
decoder layer (`parallel/sp.py`); the shards' outputs are gathered over
the mesh's sequence dims and put back in token order. Without an active
mesh it is the plain forward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class NIAHConfig:
    context_lengths: Sequence[int] = (1024, 2048)
    depths: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 1.0)
    answer_len: int = 8


@torch.no_grad()
def build_haystack_embeddings(params: Dict[str, Any], cfg, frames: np.ndarray,
                              batch_tiles: int = 8, device=None) -> torch.Tensor:
    """Vision tower + projector over (N, H, W, 3) frames -> (N *
    tokens_per_image, D), a few frames at a time
    (produce_haystack_embedding.py)."""
    from vila_tpu_torch.models import vlm

    dev = device or params["llm"]["embed_tokens"]["embedding"].device
    outs = []
    for i in range(0, frames.shape[0], batch_tiles):
        feats = vlm.encode_images(params, cfg, torch.as_tensor(frames[i:i + batch_tiles]).to(dev))
        outs.append(feats.reshape(-1, feats.shape[-1]))
    return torch.cat(outs)


def splice_needle(haystack: torch.Tensor, needle: torch.Tensor,
                  depth: float) -> Tuple[torch.Tensor, int]:
    """Insert the needle (T, D) into the haystack (S, D) at a relative
    depth. Returns (sequence, position)."""
    pos = int(depth * haystack.shape[0])
    return torch.cat([haystack[:pos], needle, haystack[pos:]]), pos


@torch.no_grad()
def forward_embeds_sharded(llm_params: Dict[str, Any], llm_cfg, embeds: torch.Tensor, mesh,
                           positions: Optional[torch.Tensor] = None,
                           ring_layout: str = "zigzag",
                           return_hidden: bool = False) -> torch.Tensor:
    """Causal forward over (1, S, D) embeddings with the sequence split over
    the mesh's sequence dims (S divisible by their product), MM-SP
    attention in every layer, so a rank's attention memory is O(S_local)
    per ring step. Returns logits (1, S, V), or the final hidden states
    with `return_hidden`, in token order on every rank
    (eval_vision_niah.py's zigzag ring)."""
    from vila_tpu_torch.models import qwen2
    from vila_tpu_torch.parallel.mesh import gather_tensor
    from vila_tpu_torch.parallel.ring_attention import inverse_zigzag_order, zigzag_order
    from vila_tpu_torch.parallel.sp import SPConfig

    s = embeds.shape[1]
    dev = embeds.device
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None]
    sp_plan = None
    if mesh is not None:
        sp_plan = SPConfig(mesh=mesh, ring_layout=ring_layout)
        if not sp_plan.active:
            sp_plan = None
        elif s % sp_plan.degree:
            raise ValueError(f"a sequence of {s} does not split over {sp_plan.degree} ranks")
    if sp_plan is None:
        out, _ = qwen2.forward(llm_params, llm_cfg, inputs_embeds=embeds, positions=positions,
                               return_hidden=return_hidden)
        return out
    layout = sp_plan.layout_for(s)
    if layout == "zigzag":
        order = torch.as_tensor(zigzag_order(s, sp_plan.ring_degree), device=dev)
        embeds, positions = embeds[:, order], positions[:, order]
    sl = mesh.seq_slice(s)
    out, _ = qwen2.forward(llm_params, llm_cfg, inputs_embeds=embeds[:, sl],
                           positions=positions[:, sl], sp=sp_plan, return_hidden=return_hidden)
    if mesh.size != sp_plan.degree:
        raise NotImplementedError("forward_embeds_sharded takes a mesh of sequence dims only")
    out = gather_tensor(out, 1)  # the shards in rank order, ring major
    if layout == "zigzag":
        inv = torch.as_tensor(inverse_zigzag_order(s, sp_plan.ring_degree), device=dev)
        out = out[:, inv]
    return out


@torch.no_grad()
def run_niah(llm_params: Dict[str, Any], llm_cfg, haystack: torch.Tensor, needle: torch.Tensor,
             answer_ids: np.ndarray, niah: NIAHConfig, mesh=None,
             query: Optional[torch.Tensor] = None, timings: Optional[list] = None
             ) -> List[Dict[str, Any]]:
    """Retrieval accuracy over the (context length, depth) grid: the share
    of the answer's tokens greedily predicted after the spliced haystack
    (and the `query` cue, when given), teacher-forced as
    eval_vision_niah.py's argmax check. The vocabulary projection runs on
    the answer's rows only. `timings`, when given, receives each forward's
    (context, depth, seconds) (the device synchronised around it)."""
    import time

    from vila_tpu_torch.models import qwen2

    results = []
    a = len(answer_ids)
    qn = 0 if query is None else query.shape[0]
    dev = haystack.device
    ans = torch.as_tensor(np.asarray(answer_ids)[None], device=dev)
    for ctx in niah.context_lengths:
        hs = haystack[:ctx - needle.shape[0] - qn - a]
        for depth in niah.depths:
            seq, _ = splice_needle(hs, needle, depth)
            if query is not None:
                seq = torch.cat([seq, query])
            ans_embeds = qwen2.embed_tokens(llm_params, llm_cfg, ans)[0]
            full = torch.cat([seq.to(ans_embeds.dtype), ans_embeds])[None]
            if mesh is not None:  # 2·sp multiple, so that the zigzag layout applies
                m = 2 * mesh.shape.get("sp", 1) * mesh.shape.get("su", 1)
                pad = (-full.shape[1]) % m
                if pad:
                    full = torch.nn.functional.pad(full, (0, 0, 0, pad))
            if timings is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            hidden = forward_embeds_sharded(llm_params, llm_cfg, full, mesh, return_hidden=True)
            start = seq.shape[0] - 1
            logits = qwen2.compute_logits(llm_params, llm_cfg, hidden[:, start:start + a])
            pred = torch.argmax(logits[0], -1).cpu().numpy()
            if timings is not None:
                timings.append((int(ctx), float(depth), time.perf_counter() - t0))
            acc = float((pred == np.asarray(answer_ids)).mean())
            results.append({"context": int(ctx), "depth": float(depth), "acc": acc})
    return results
