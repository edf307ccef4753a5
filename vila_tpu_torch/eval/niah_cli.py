"""Command line of the NIAH harness, as `vila_tpu/eval/niah_cli.py`:
haystack embeddings from the model's own vision tower over random frames, a
needle block, teacher-forced retrieval accuracy over the (context, depth)
grid, a metrics.json and (with matplotlib) a heatmap.

    python -m vila_tpu_torch.eval.niah_cli --model-path ckpt/ --output-dir out/ \
        [--device cpu] [--contexts 1024 2048]

With `--sp N` under torchrun (N processes, one device each) the forward runs
ring attention over the N ranks; rank 0 writes the outputs.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def save_heatmap(results, path: str) -> bool:
    """Accuracy heatmap over (context length x needle depth) — the artifact
    of the reference's eval_vision_niah.py plot. Sequential single-hue
    (magnitude encoding), per-cell value labels, no rainbow."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False

    contexts = sorted({r["context"] for r in results})
    depths = sorted({r["depth"] for r in results})
    grid = np.full((len(depths), len(contexts)), np.nan)
    for r in results:
        grid[depths.index(r["depth"]), contexts.index(r["context"])] = r["acc"]

    fig, ax = plt.subplots(
        figsize=(1.2 + 0.9 * len(contexts), 1.0 + 0.6 * len(depths))
    )
    im = ax.imshow(grid, cmap="Greens", vmin=0.0, vmax=1.0, aspect="auto")
    ax.set_xticks(range(len(contexts)))
    ax.set_xticklabels(
        [f"{c//1024}k" if c >= 1024 else str(c) for c in contexts]
    )
    ax.set_yticks(range(len(depths)))
    ax.set_yticklabels([f"{d:.0%}" for d in depths])
    ax.set_xlabel("context length (tokens)")
    ax.set_ylabel("needle depth")
    ax.set_title("Needle-in-a-haystack retrieval accuracy")
    for i in range(len(depths)):
        for j in range(len(contexts)):
            v = grid[i, j]
            if not np.isnan(v):
                ax.text(
                    j, i, f"{v:.2f}", ha="center", va="center", fontsize=8,
                    color="white" if v > 0.6 else "#1a1a1a",
                )
    fig.colorbar(im, ax=ax, label="accuracy")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return True


def main(argv=None) -> int:
    p = argparse.ArgumentParser("vila_tpu_torch.eval.niah_cli")
    p.add_argument("--model-path", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--contexts", type=int, nargs="+", default=[1024, 2048])
    p.add_argument("--depths", type=float, nargs="+",
                   default=[0.0, 0.25, 0.5, 0.75, 1.0])
    p.add_argument("--num-frames", type=int, default=32)
    p.add_argument("--answer", default="the secret word is needle")
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    args = p.parse_args(argv)

    import torch

    from vila_tpu_torch import entry
    from vila_tpu_torch.eval import niah

    mesh = None
    if args.sp > 1:
        from vila_tpu_torch.parallel import distributed, mesh as mesh_lib

        distributed.init_distributed(backend="gloo" if args.device == "cpu" else None)
        mesh = mesh_lib.make_mesh(sp=args.sp)
    engine = entry.load(args.model_path, device=args.device)
    cfg = engine.cfg
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    frames = rng.integers(0, 255, (args.num_frames, size, size, 3), np.uint8)
    haystack = niah.build_haystack_embeddings(engine.params, cfg, frames)
    needle = torch.as_tensor(rng.normal(size=(8, haystack.shape[-1])).astype(np.float32),
                             device=haystack.device).to(haystack.dtype)
    answer_ids = np.asarray(
        engine.tokenizer(args.answer, add_special_tokens=False).input_ids, np.int64)
    results = niah.run_niah(
        engine.params["llm"], cfg.llm, haystack, needle, answer_ids,
        niah.NIAHConfig(context_lengths=args.contexts, depths=args.depths), mesh=mesh)
    mean_acc = float(np.mean([r["acc"] for r in results]))
    if mesh is None or mesh.rank == 0:
        os.makedirs(args.output_dir, exist_ok=True)
        with open(os.path.join(args.output_dir, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
            json.dump({"niah/mean_acc": mean_acc, "niah/grid": results}, f)
        save_heatmap(results, os.path.join(args.output_dir, "niah_heatmap.png"))
        print(json.dumps({"niah/mean_acc": mean_acc}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
